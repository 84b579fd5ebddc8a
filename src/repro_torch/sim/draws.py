"""Uniform random numbers for the Monte-Carlo sims.

Every sim draws through one source that the runner passes in. A source
has three methods, each returning f32 uniforms in [1e-7, 1):

* `uniform(strategy, rep, name, shape, device)`, for one (strategy,
  replication, draw name, shape): the flat paths (`sim.runner`,
  `cluster.engine`);
* `uniform_rows(strategy, rep, name, cells, rows, rest, device, tag=)`,
  (T,) + rest uniforms whose row t is drawn at the coordinates
  (cells[t], rows[t]) and depends on nothing else: not on which other
  rows are drawn, how many, or in what order. `cells` and `rows` are
  int64 tensors (T,) or ints, broadcast together; `tag` separates the
  users: `FLEET_TAG` (the fleet layer, `repro_torch.fleet`: a cell is a
  job block's GLOBAL index, or `NO_BLOCK` for the capacity fleet, whose
  windows draw per replication; a row is a task row of the block) and
  `SERVE_TAG` (serving, `repro_torch.serve`: a cell is a request's rid,
  its row 0). So a chunked fleet run draws what a monolithic one does,
  and a request draws the same whatever window, slice or stream it is
  served in;
* `uniform_cell(strategy, rep, block, name, shape, device)`: one fleet
  cell, `uniform_rows` over the cell `block` (None: `NO_BLOCK`) and rows
  0..shape[0]-1.

The draw names follow the reference's key splits: "k1"/"k2" where
a sim splits its key in two (srestart, sresume, hadoop_s, mantri, hedge,
adaptive), "key" where it draws from its key directly (clone, hadoop_ns
and the two clone_* specs).

`Philox` is the production source. A test can hand the runner any object
with the same methods, for example one that replays the reference's
`jax.random` draws under the reference's own keys.

Workload synthesis (`repro_torch.workloads`) draws through a second kind
of source, with one method per law: `categorical`, `normal`, `uniform`,
`exponential` and `bernoulli`, each taking a draw name from
`WORKLOAD_DRAWS` (the reference's key splits, `workloads/traces.py` and
`generators.py`). `WorkloadPhilox` is its production form; a test hands in
a source that returns the reference's own variates, so parity covers the
transforms from variates to columns.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

#: stable ids of the draw names, part of each generator's seed
DRAW_NAMES = ("key", "k1", "k2")

_MINVAL = float(np.float32(1e-7))
# (maxval - minval) evaluated in f32, as jax.random.uniform does
_SPAN = float(np.float32(1.0) - np.float32(1e-7))


def to_uniform(u01: torch.Tensor) -> torch.Tensor:
    """Map [0, 1) to [1e-7, 1) in place as `jax.random.uniform(minval=1e-7,
    maxval=1.0)` does: an affine map, then a max with minval."""
    return u01.mul_(_SPAN).add_(_MINVAL).clamp_min_(_MINVAL)


#: the tags of `uniform_rows`, the second entropy word of its keys: no
#: fleet stream coincides with a serving one, and neither with a flat one
#: (whose entropy has four words, not five)
FLEET_TAG = 0x666C6565
SERVE_TAG = 0x73657276

#: the cell of the capacity fleet's draws, which have no block
NO_BLOCK = -1


def _seed_of(entropy) -> int:
    lo, hi = np.random.SeedSequence(entropy).generate_state(2, np.uint32)
    return (int(hi) << 32 | int(lo)) & (2**63 - 1)


@functools.lru_cache(maxsize=4096)
def _key_of(entropy) -> tuple:
    """The two 32-bit Philox key words of a `uniform_rows` stream."""
    return tuple(int(k) for k in
                 np.random.SeedSequence(entropy).generate_state(2, np.uint32))


def _rand(seed: int, shape, device) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return to_uniform(torch.rand(tuple(shape), generator=gen, device=device,
                                 dtype=torch.float32))


def _coords(cells, rows, device) -> tuple:
    """cells and rows as contiguous (T,) int64 tensors on `device`; an int
    is filled to the other's length on the device (no host copy)."""
    def column(x, like):
        if isinstance(x, torch.Tensor):
            return x.to(device=device, dtype=torch.int64).contiguous()
        if like is None:
            raise ValueError("uniform_rows: cells or rows must be a tensor")
        return torch.full((like.shape[0],), int(x), dtype=torch.int64,
                          device=device)
    c = column(cells, rows if isinstance(rows, torch.Tensor) else None)
    r = column(rows, c)
    if c.dim() != 1 or r.shape != c.shape:
        raise ValueError(f"uniform_rows: cells {tuple(c.shape)} and rows "
                         f"{tuple(r.shape)} must both be (T,)")
    return c, r


class Philox:
    """The production source. `uniform` seeds one torch.Generator per draw
    from (seed, registry index of the strategy, replication, draw name);
    on a CUDA device `torch.rand` runs Philox4x32 on the card.
    `uniform_rows` keys counter-based Philox4x32-10
    (`kernels/philox.py`, one launch a call on the card) by (seed, tag,
    strategy index, replication, draw name), and each row's counter by
    its coordinates. A strategy's draws depend only on its own registry
    index, so subsetting or reordering strategies never changes another
    strategy's numbers.
    """

    def __init__(self, seed: int = 0):
        self.seed = int(seed)

    def generator_seed(self, strategy: str, rep: int, name: str) -> int:
        from ..strategies import index_of
        return _seed_of((self.seed, index_of(strategy), int(rep),
                         DRAW_NAMES.index(name)))

    def rows_key(self, strategy: str, rep: int, name: str,
                 tag: int = FLEET_TAG) -> tuple:
        from ..strategies import index_of
        return _key_of((self.seed, int(tag), index_of(strategy), int(rep),
                        DRAW_NAMES.index(name)))

    def uniform(self, strategy: str, rep: int, name: str, shape,
                device) -> torch.Tensor:
        return _rand(self.generator_seed(strategy, rep, name), shape, device)

    def uniform_rows(self, strategy: str, rep: int, name: str, cells, rows,
                     rest, device, tag: int = FLEET_TAG) -> torch.Tensor:
        from ..kernels.philox import philox_rows
        c, r = _coords(cells, rows, device)
        rest = tuple(int(d) for d in rest)
        u = philox_rows(c, r, math.prod(rest),
                        self.rows_key(strategy, rep, name, tag))
        return u.reshape((c.shape[0],) + rest)

    def uniform_cell(self, strategy: str, rep: int, block, name: str, shape,
                     device) -> torch.Tensor:
        return uniform_cell(self, strategy, rep, block, name, shape, device)


def uniform_cell(source, strategy: str, rep: int, block, name: str, shape,
                 device) -> torch.Tensor:
    """One fleet cell through `source.uniform_rows`: rows 0..shape[0]-1 of
    the cell `block` (None: `NO_BLOCK`)."""
    rows = torch.arange(int(shape[0]), dtype=torch.int64, device=device)
    return source.uniform_rows(strategy, rep, name,
                               NO_BLOCK if block is None else int(block),
                               rows, tuple(shape[1:]), device, tag=FLEET_TAG)


#: stable ids of the workload draw names, part of each generator's seed.
#: The reference splits PRNGKey(seed) into four keys (mix, counts,
#: Pareto parameters, arrivals); "t_min"/"beta" are the two halves of the
#: parameter key, and each arrival process names the halves of the
#: arrival key it splits
WORKLOAD_DRAWS = ("classes", "task_counts", "t_min", "beta", "arrival",
                  "arrival.new_batch", "arrival.gap", "arrival.dwell",
                  "arrival.unit")


class WorkloadPhilox:
    """torch.Generator-backed workload source: one generator per draw
    name, seeded from (seed, index of the name in WORKLOAD_DRAWS); Philox
    on the card. Each method returns the variates of its law directly
    from uniforms or normals of that generator.
    """

    def __init__(self, seed: int = 0):
        self.seed = int(seed)

    def generator(self, name: str, device) -> torch.Generator:
        entropy = (self.seed, WORKLOAD_DRAWS.index(name))
        lo, hi = np.random.SeedSequence(entropy).generate_state(2, np.uint32)
        gen = torch.Generator(device=device)
        gen.manual_seed((int(hi) << 32 | int(lo)) & (2**63 - 1))
        return gen

    def uniform(self, name: str, shape, device) -> torch.Tensor:
        """f32 uniforms in [0, 1)."""
        return torch.rand(tuple(shape), generator=self.generator(name, device),
                          device=device, dtype=torch.float32)

    def normal(self, name: str, shape, device) -> torch.Tensor:
        return torch.randn(tuple(shape),
                           generator=self.generator(name, device),
                           device=device, dtype=torch.float32)

    def exponential(self, name: str, shape, device) -> torch.Tensor:
        """Exp(1) by inverse CDF, -log(1 - u), u in [0, 1)."""
        return torch.log1p(-self.uniform(name, shape, device)).neg_()

    def bernoulli(self, name: str, p: float, shape, device) -> torch.Tensor:
        """bool, True with probability p: u < p."""
        return self.uniform(name, shape, device) < p

    def categorical(self, name: str, logits: torch.Tensor,
                    shape) -> torch.Tensor:
        """int32 class ids ~ softmax(logits) by inverse CDF: the number of
        cumulative probabilities at or below u, clamped to the last
        class."""
        probs = torch.softmax(logits.to(torch.float32), dim=0)
        cdf = probs.clone()     # summed in order (cumsum is not, on CUDA)
        for k in range(1, cdf.shape[0]):
            cdf[k] = cdf[k - 1] + probs[k]
        u = self.uniform(name, shape, logits.device)
        k = torch.searchsorted(cdf, u.reshape(-1), right=True)
        return k.clamp_(max=logits.shape[0] - 1).to(torch.int32).reshape(
            tuple(shape))
