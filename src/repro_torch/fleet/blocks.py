"""Job-block decomposition: a flat JobSet as fixed-shape job blocks;
counterpart of `repro.fleet.blocks`.

`make_blocks` partitions jobs into contiguous blocks of `block_jobs` jobs
(every task of a job in its job's block) and pads each block to one
shape: (G_pad, Jb) per-job rows with Jb = block_jobs + 1, row Jb - 1 a
dummy job that absorbs every padding task, and (G_pad, Tb) per-task rows.
`block_id` is the GLOBAL block index, which keys the block's draws
(`sim.draws`), so draws depend on neither the padding nor the chunk
split. Global job j lives at block j // block_jobs, row j % block_jobs
(`gather_index`).

The geometry (`block_layout`) is host numpy, copied from the reference;
the leaves are torch tensors on the run's device, and the per-task
leaves are built there from the per-job rows (one `repeat_interleave`),
so the host never walks the task axis. `BlockLayout.g_t` / `off_t` are
formed on demand for `stack_task_column`.

The fleet runner simulates `block_view`: all of a chunk's blocks as one
flat JobSet of their real tasks, each block drawing the first rows of its
(Tb, ...) cell.

The dummy row's `n_tasks` is the reference's, max(padding, 1), so a full
block's dummy row claims one task it does not have. `block_jobset` and
`block_view` count each row's tasks from the layout instead: the port's
`segment_sum` reads `n_tasks` as segment lengths.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device, to_host
from ..sim.trace import JobSet

#: benign Pareto parameters for padding rows: finite draws, never read.
_FILL = {"t_min": 1.0, "beta": 2.0, "D": 1.0}

#: a block's task rows in `block_view` take a multiple of this: the CPU's
#: elementwise kernels run a vector loop over 32 floats at a time (2 x 16
#: lanes with AVX-512) and a scalar loop over the rest, whose pow differs
#: from the vector loop's in the last bits, so a task's draws would depend
#: on whether its chunk's view ends near it; with every block a multiple
#: of 32 tasks, no task of any view falls in that rest
ALIGN = 32

_JOB_LEAVES = ("n_tasks", "t_min", "beta", "D", "arrival", "C", "job_class",
               "theta_scale")


class FleetBlocks(NamedTuple):
    """Block-stacked JobSet tensors on one device."""
    block_id: torch.Tensor     # (G_pad,) int32 global block index
    job_valid: torch.Tensor    # (G_pad, Jb) bool, real job rows
    n_tasks: torch.Tensor      # (G_pad, Jb) int32 (dummy row: max(pad, 1))
    t_min: torch.Tensor        # (G_pad, Jb) f32
    beta: torch.Tensor         # (G_pad, Jb) f32
    D: torch.Tensor            # (G_pad, Jb) f32
    arrival: torch.Tensor      # (G_pad, Jb) f32
    C: torch.Tensor            # (G_pad, Jb) f32
    job_class: torch.Tensor    # (G_pad, Jb) int32
    theta_scale: torch.Tensor  # (G_pad, Jb) f32
    job_id: torch.Tensor       # (G_pad, Tb) int32 block-LOCAL job row
    task_valid: torch.Tensor   # (G_pad, Tb) bool, real task rows
    task_t_min: torch.Tensor   # (G_pad, Tb) f32
    task_beta: torch.Tensor    # (G_pad, Tb) f32
    task_D: torch.Tensor       # (G_pad, Tb) f32

    @property
    def n_blocks(self) -> int:
        return int(self.block_id.shape[0])

    @property
    def jobs_per_block(self) -> int:
        return int(self.n_tasks.shape[1]) - 1


def _true_counts(job_id: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Tasks per job row, counted from the task -> row column."""
    return torch.bincount(job_id, minlength=n_rows).to(torch.int32)


def block_jobset(blk) -> JobSet:
    """View one block (leaves sliced to (Jb,) / (Tb,)) as a JobSet; its
    `n_tasks` are the rows' true task counts."""
    job_id = blk.job_id.to(torch.int64)
    Jb = int(blk.n_tasks.shape[0])
    return JobSet(
        n_jobs=Jb, n_tasks=_true_counts(job_id, Jb), t_min=blk.t_min,
        beta=blk.beta, D=blk.D, arrival=blk.arrival, C=blk.C,
        job_class=blk.job_class, theta_scale=blk.theta_scale,
        job_id=job_id, task_t_min=blk.task_t_min,
        task_beta=blk.task_beta, task_D=blk.task_D)


def block_task_counts(n_tasks, block_jobs: int) -> np.ndarray:
    """(G,) task count per block for per-job counts `n_tasks` (host side);
    fixes one global Tb before any chunk is built."""
    n_tasks = to_host(n_tasks).astype(np.int64)
    J = int(n_tasks.shape[0])
    G = -(-J // block_jobs)
    pad = G * block_jobs - J
    return np.pad(n_tasks, (0, pad)).reshape(G, block_jobs).sum(axis=1)


def gather_index(n_jobs: int, block_jobs: int) -> np.ndarray:
    """(J,) flat index of job j inside the (G_pad * Jb) stacked job rows,
    the inverse of the `make_blocks` row placement (host numpy)."""
    j = np.arange(n_jobs)
    jb = block_jobs + 1
    return (j // block_jobs) * jb + (j % block_jobs)


class BlockLayout(NamedTuple):
    """The host-side block geometry, computed once per chunk and shared by
    `make_blocks` and every `stack_task_column` call."""
    block_jobs: int           # B
    n_blocks: int             # G (real)
    n_blocks_padded: int      # G_pad
    tasks_per_block: int      # Tb
    counts: np.ndarray        # (G,) tasks per real block
    g_j: np.ndarray           # (J,) block of job j
    row_j: np.ndarray         # (J,) row of job j inside its block
    job_tasks: np.ndarray     # (J,) int64 tasks of job j

    @property
    def g_t(self) -> np.ndarray:
        """(T,) block of flat task t."""
        return np.repeat(self.g_j, self.job_tasks)

    @property
    def off_t(self) -> np.ndarray:
        """(T,) row of flat task t inside its block."""
        job_start = np.concatenate([[0], np.cumsum(self.job_tasks)])
        blk_start = job_start[np.arange(self.n_blocks) * self.block_jobs]
        g_t = self.g_t
        return np.arange(g_t.shape[0]) - blk_start[g_t]

    def stack_jobs(self, x, fill, dtype) -> np.ndarray:
        out = np.full((self.n_blocks_padded, self.block_jobs + 1), fill,
                      dtype)
        out[self.g_j, self.row_j] = to_host(x)
        return out

    def stack_tasks(self, x, fill, dtype) -> np.ndarray:
        out = np.full((self.n_blocks_padded, self.tasks_per_block), fill,
                      dtype)
        out[self.g_t, self.off_t] = to_host(x)
        return out


def block_layout(jobs, block_jobs: int, pad_blocks_to: int = 1,
                 tasks_pad: int = 0, min_blocks: int = 0) -> BlockLayout:
    """The decomposition geometry (host numpy, O(J)) of a JobSet, or of
    any record of per-job columns with `n_tasks` (a WorkloadTrace).

    pad_blocks_to: round the block count up to a multiple of the mesh's
        "job" extent; padded blocks hold only dummy rows.
    tasks_pad: minimum Tb (0 = this JobSet's own max block task count);
        the chunked streamer passes the global maximum.
    min_blocks: minimum G_pad; the chunked streamer passes the per-chunk
        block count so a short final chunk keeps the same shape.
    """
    if block_jobs < 1:
        raise ValueError(f"block_jobs must be >= 1, got {block_jobs}")
    n_tasks = to_host(jobs.n_tasks).astype(np.int64)
    J = int(n_tasks.shape[0])
    B = int(block_jobs)
    G = -(-J // B)
    G_pad = max(-(-G // pad_blocks_to) * pad_blocks_to, int(min_blocks))
    counts = block_task_counts(n_tasks, B)
    Tb = max(int(counts.max()) if G else 0, int(tasks_pad), 1)
    j = np.arange(J)
    return BlockLayout(
        block_jobs=B, n_blocks=G, n_blocks_padded=G_pad,
        tasks_per_block=Tb, counts=counts, g_j=j // B, row_j=j % B,
        job_tasks=n_tasks)


def _job_leaves(jobs, layout: BlockLayout, block_offset: int, dev,
                blocks=None):
    """The per-job leaves of blocks [g0, g1) (`blocks`; None: all G_pad)
    as (g1 - g0, Jb) tensors on `dev`, their (g1 - g0,) global block ids,
    and the rows' true task counts (host int64, the dummy row's the
    block's padding to Tb)."""
    B, G, G_pad = layout.block_jobs, layout.n_blocks, layout.n_blocks_padded
    g0, g1 = (0, G_pad) if blocks is None else blocks
    stack = lambda x, fill, dt: layout.stack_jobs(x, fill, dt)[g0:g1]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    true_nt = stack(layout.job_tasks, 0, np.int64)
    true_nt[:, B] = layout.tasks_per_block - np.pad(layout.counts,
                                                    (0, G_pad - G))[g0:g1]
    # the reference's n_tasks: the dummy row claims max(padding, 1)
    nt = true_nt.astype(np.int32)
    nt[:, B] = np.maximum(true_nt[:, B], 1)
    cols = {f: to_host(getattr(jobs, f)) for f in _JOB_LEAVES[1:]}
    leaves = dict(
        block_id=t((block_offset + np.arange(g0, g1)).astype(np.int32)),
        job_valid=t(stack(np.ones(int(layout.g_j.shape[0]), bool), False,
                          bool)),
        n_tasks=t(nt),
        t_min=t(stack(cols["t_min"], _FILL["t_min"], np.float32)),
        beta=t(stack(cols["beta"], _FILL["beta"], np.float32)),
        D=t(stack(cols["D"], _FILL["D"], np.float32)),
        arrival=t(stack(cols["arrival"], 0.0, np.float32)),
        C=t(stack(cols["C"], 0.0, np.float32)),
        job_class=t(stack(cols["job_class"], 0, np.int32)),
        theta_scale=t(stack(cols["theta_scale"], 1.0, np.float32)))
    return leaves, true_nt


def _task_rows(row_tasks: np.ndarray, dev) -> torch.Tensor:
    """Each task's flat job row: row r repeated row_tasks[r] times, in row
    order (a block's tasks are its jobs' in job order, then its dummy
    row's)."""
    counts = row_tasks.reshape(-1)
    return torch.repeat_interleave(
        torch.arange(counts.shape[0], device=dev),
        torch.from_numpy(np.ascontiguousarray(counts)).to(dev),
        output_size=int(counts.sum()))


def make_blocks(jobs, block_jobs: int, pad_blocks_to: int = 1,
                tasks_pad: int = 0, block_offset: int = 0,
                min_blocks: int = 0, layout: BlockLayout = None, *,
                device=None) -> FleetBlocks:
    """Decompose a JobSet (or per-job columns) into padded fixed-shape
    blocks on `device` (default the card). See `block_layout` for the
    geometry; `block_offset` is the global index of the first block.
    Every field equals the reference's `make_blocks`."""
    dev = resolve_device(device)
    if layout is None:
        layout = block_layout(jobs, block_jobs, pad_blocks_to, tasks_pad,
                              min_blocks)
    B, G_pad = layout.block_jobs, layout.n_blocks_padded
    Tb = layout.tasks_per_block
    leaves, true_nt = _job_leaves(jobs, layout, block_offset, dev)
    rows = _task_rows(true_nt, dev)
    local = (rows % (B + 1)).to(torch.int32).view(G_pad, Tb)
    per_task = lambda x: x.reshape(-1)[rows].view(G_pad, Tb)
    return FleetBlocks(
        **leaves, job_id=local, task_valid=local != B,
        task_t_min=per_task(leaves["t_min"]),
        task_beta=per_task(leaves["beta"]),
        task_D=per_task(leaves["D"]))


class BlockView(NamedTuple):
    """A chunk's blocks as one flat JobSet (`block_view`)."""
    jobs: JobSet              # G * Jb job rows; the blocks' tasks
    task_valid: torch.Tensor  # (T_view,) bool, real tasks
    block_ids: tuple          # (G,) global block index
    starts: np.ndarray        # (G,) each block's first task row
    counts: np.ndarray        # (G,) each block's real tasks


def block_view(jobs, layout: BlockLayout, block_offset: int = 0, *,
               blocks=None, device=None) -> BlockView:
    """The blocks [g0, g1) of `layout` (`blocks`; None: all G_pad, as a
    mesh point's share or the whole chunk) as ONE flat JobSet on `device`
    (default the card): (g1 - g0) * Jb job rows (row g * Jb + j) holding
    their real tasks only, each block's rows starting at a multiple of
    `ALIGN` (the gap goes to its dummy row) and `n_tasks` the rows' true
    counts. Task i of block g is task i of the reference's (Tb,)-row
    block, so a sim whose draws are task-major computes on this view what
    it computes per block on the padded layout, and every per-job segment
    stays in its block."""
    dev = resolve_device(device)
    B, G, G_pad = layout.block_jobs, layout.n_blocks, layout.n_blocks_padded
    g0, g1 = (0, G_pad) if blocks is None else blocks
    leaves, true_nt = _job_leaves(jobs, layout, block_offset, dev, (g0, g1))
    counts = np.pad(layout.counts, (0, G_pad - G)).astype(np.int64)[g0:g1]
    width = -(-counts // ALIGN) * ALIGN
    true_nt[:, B] = width - counts
    rows = _task_rows(true_nt, dev)
    flat = lambda x: x.reshape(-1)
    view = JobSet(
        n_jobs=(g1 - g0) * (B + 1),
        n_tasks=torch.from_numpy(true_nt.reshape(-1).astype(np.int32)).to(
            dev),
        t_min=flat(leaves["t_min"]), beta=flat(leaves["beta"]),
        D=flat(leaves["D"]), arrival=flat(leaves["arrival"]),
        C=flat(leaves["C"]), job_class=flat(leaves["job_class"]),
        theta_scale=flat(leaves["theta_scale"]), job_id=rows,
        task_t_min=flat(leaves["t_min"])[rows],
        task_beta=flat(leaves["beta"])[rows],
        task_D=flat(leaves["D"])[rows])
    return BlockView(
        jobs=view, task_valid=(rows % (B + 1)) != B,
        block_ids=tuple(block_offset + g for g in range(g0, g1)),
        starts=np.concatenate([[0], np.cumsum(width)[:-1]]), counts=counts)


def stack_task_column(layout: BlockLayout, x, fill, dtype, *,
                      device=None) -> torch.Tensor:
    """Stack one extra flat per-task column (e.g. r_task) on a layout."""
    return torch.from_numpy(layout.stack_tasks(x, fill, dtype)).to(
        resolve_device(device))
