"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled on first
use into `build/<name>-<hash>.so` beside this module; the hash covers the
source, the shared headers (`csrc/*.h`) and the flags, so an edited
source is rebuilt and an unchanged one is reused. Nothing here runs at
import time: a host without nvcc can import the package and use the
plain PyTorch versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"

#: nvcc builds run in this process; `obs.fenced` marks a span in which it
#: grew
compiles = 0
#: seconds from the start of each source's nvcc to its exit, by name, of
#: the builds run in this process (the sources build in parallel)
seconds = {}

# IEEE powf/logf/expf (no --use_fast_math): the grid solve's argmax must
# match the plain version's
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if CUDA_HOME is not None and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        found = str(Path(CUDA_HOME) / "bin" / "nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.h")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD / f"{name}-{digest[:16]}.so"


def compile_sources(names) -> dict:
    """Compile every named source that is not built yet, one nvcc process
    per source, all started together. Returns {name: .so path}; the
    compiler's output (ptxas register and spill report) is kept beside
    each library as `.log`, and each build's seconds in `seconds`."""
    global compiles
    targets = {n: _target(n) for n in names}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    if todo:
        compiles += len(todo)
        BUILD.mkdir(exist_ok=True)
        exe = nvcc()
        procs = {}
        t0 = time.perf_counter()
        for n, t in todo.items():
            tmp = t.with_name(f"{t.name}.{os.getpid()}.tmp")
            log = t.with_name(f"{t.name}.{os.getpid()}.log")
            with open(log, "w") as f:
                procs[n] = (tmp, log, subprocess.Popen(
                    [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
                    stdout=f, stderr=subprocess.STDOUT))
        running = set(procs)
        while running:
            # every process polled on each pass, so each source's seconds
            # are its own nvcc's
            for n in sorted(running):
                if procs[n][2].poll() is not None:
                    seconds[n] = time.perf_counter() - t0
                    running.discard(n)
            if running:
                time.sleep(0.05)
        failed = []
        for n, (tmp, log, proc) in procs.items():
            out = log.read_text()
            os.replace(log, todo[n].with_suffix(".log"))
            if proc.returncode != 0:
                failed.append(f"{n}.cu:\n{out}")
            else:
                os.replace(tmp, todo[n])
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return targets


def build_log(name: str) -> str:
    """The compiler's output of the current build of `name`."""
    return _target(name).with_suffix(".log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    return ctypes.CDLL(str(compile_sources([name])[name]))
