"""The reduction of a profiler trace (Chrome JSON, as `torch.profiler`
exports it) to what the per-layer metrics read.

Device activity is every kernel, copy and fill event. Its union, clipped
to the window's two markers (`train.WINDOW_START`, `WINDOW_END`, host
ranges with no work), is the busy time; the window is the markers'
distance. Kernels launched inside a host range (the optimizer's) are
found by the launch's correlation id. Idle gaps are the holes in the
union, each charged to the innermost host range running on the
launching thread when it began.
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def union(intervals) -> list:
    """Sorted, merged [(start, end)]."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def total(intervals) -> float:
    return sum(e - s for s, e in intervals)


def clip(intervals, lo, hi) -> list:
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def load(path) -> list:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def reduce(events: list, window_start: str, window_end: str,
           ranges=(), top: int = 10) -> dict:
    """Busy and window seconds, device time by kernel name, each named
    host range's kernels (busy seconds and launches), and the idle gaps
    by host activity. Times in the trace are microseconds."""
    marks, device, host, launches = {}, [], [], {}
    range_spans = defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append((ts, ts + dur, name,
                           e.get("args", {}).get("correlation")))
        elif cat in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (ts, e.get("tid"))
        elif cat in HOST_CATS:
            if name in (window_start, window_end):
                marks[name] = ts
            elif name in ranges:
                range_spans[name].append((ts, ts + dur, e.get("tid")))
            host.append((ts, ts + dur, name, e.get("tid")))
    if window_start not in marks or window_end not in marks:
        raise ValueError("trace: the window's markers are missing")
    lo, hi = marks[window_start], marks[window_end]
    busy = clip(union((s, e) for s, e, _, _ in device), lo, hi)
    by_name = defaultdict(lambda: [0.0, 0])
    for s, e, name, _ in device:
        c = clip([(s, e)], lo, hi)
        if c:
            by_name[name][0] += total(c)
            by_name[name][1] += 1
    in_range = {}
    for r, spans in range_spans.items():
        spans.sort()
        starts = [s for s, _, _ in spans]
        mine = []
        for s, e, _, corr in device:
            at = launches.get(corr)
            if at is None:
                continue
            i = bisect.bisect_right(starts, at[0]) - 1
            if i >= 0 and spans[i][0] <= at[0] <= spans[i][1] and \
                    spans[i][2] == at[1]:
                mine.append((s, e))
        u = clip(union(mine), lo, hi)
        in_range[r] = {"busy_us": total(u), "kernels": len(mine)}
    gaps = idle_gaps(busy, lo, hi, host, launches)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {"window_us": hi - lo, "busy_us": total(busy),
            "kernels": {n: {"us": v[0], "count": v[1]}
                        for n, v in by_name.items()},
            "ranges": in_range,
            "device_ops": [[n[:120], v[0] / 1e6] for n, v in ops[:top]],
            "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1])[:top]}


def idle_gaps(busy, lo, hi, host, launches) -> dict:
    """Seconds of idle device time by the innermost host range running,
    on the thread that launched most kernels, at each gap's start."""
    count = defaultdict(int)
    for _, tid in launches.values():
        count[tid] += 1
    main = max(count, key=count.get) if count else None
    spans = sorted((s, e, n) for s, e, n, t in host if t == main)
    holes, prev = [], lo
    for s, e in busy:
        if s > prev:
            holes.append((prev, s))
        prev = max(prev, e)
    if hi > prev:
        holes.append((prev, hi))
    # one sweep: host ranges nest, so the open ones form a stack whose top
    # is the innermost range holding a hole's start
    out, stack, i = defaultdict(float), [], 0
    for s, e in holes:
        while i < len(spans) and spans[i][0] <= s:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < s:
            stack.pop()
        name = stack[-1][2] if stack else "no host range"
        out[name[:120]] += (e - s) / 1e6
    return dict(out)


def kernel_time(red: dict, part: str) -> tuple:
    """(device seconds, launches) of the kernels whose name holds `part`."""
    us, n = 0.0, 0
    for name, v in red["kernels"].items():
        if part in name:
            us += v["us"]
            n += v["count"]
    return us / 1e6, n
