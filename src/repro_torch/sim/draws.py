"""Uniform random numbers for the Monte-Carlo sims.

Every sim draws through one source that the runner passes in. A source
has one method, `uniform(strategy, rep, name, shape, device)`, and returns
f32 uniforms in [1e-7, 1) for one (strategy, replication, draw name,
shape). The draw names follow the reference's key splits: "k1"/"k2" where
a sim splits its key in two (srestart, sresume, hadoop_s, mantri, hedge,
adaptive), "key" where it draws from its key directly (clone, hadoop_ns
and the two clone_* specs).

`Philox` is the production source. A test can hand the runner any object
with the same method, for example one that replays the reference's
`jax.random` draws under the reference's own keys.
"""
from __future__ import annotations

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


class Philox:
    """torch.Generator-backed source: one generator per draw, seeded from
    (seed, registry index of the strategy, replication, draw name).

    On a CUDA device `torch.rand` runs Philox4x32 on the card. A strategy's
    draws depend only on its own registry index, so subsetting or
    reordering strategies never changes another strategy's numbers.
    """

    def __init__(self, seed: int = 0):
        self.seed = int(seed)

    def generator_seed(self, strategy: str, rep: int, name: str) -> int:
        from ..strategies import index_of
        entropy = (self.seed, index_of(strategy), int(rep),
                   DRAW_NAMES.index(name))
        lo, hi = np.random.SeedSequence(entropy).generate_state(2, np.uint32)
        return (int(hi) << 32 | int(lo)) & (2**63 - 1)

    def uniform(self, strategy: str, rep: int, name: str, shape,
                device) -> torch.Tensor:
        gen = torch.Generator(device=device)
        gen.manual_seed(self.generator_seed(strategy, rep, name))
        u = torch.rand(tuple(shape), generator=gen, device=device,
                       dtype=torch.float32)
        return to_uniform(u)
