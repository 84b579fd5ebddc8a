"""The weights of a run, made from `--seed` on the device.

Each leaf (named by its path in the model's parameter tree, e.g.
`blocks.3.attn.wq`) is drawn in chunks of `CHUNK` elements, each chunk
from a generator seeded by (seed, leaf, chunk): a few dozen large calls
for a whole model, and any chunk can be drawn again alone, so that the
reference and the change of the parameters need no second copy of the
model. Matrices are 0.02 N(0, 1), the embedding N(0, 1), the norms'
scales 0 (the models scale by 1 + w).
"""
from __future__ import annotations

import numpy as np
import torch

from .model_shape import ModelShape

CHUNK = 1 << 26
_TAG = 0x5745_4947     # keeps these seeds apart from the token stream's
_PROBE_TAG = 0x5052_4F42
#: random directions that each leaf's change is projected onto
PROBES = 16


def leaves(s: ModelShape) -> list:
    """[(name, shape, scale)] in a fixed order; scale 0 is a zero leaf."""
    d, H, K, Dh, F = s.d_model, s.n_heads, s.n_kv_heads, s.head_dim, s.d_ff
    out = [("embed", (s.vocab, d), 1.0)]
    for i in range(s.n_layers):
        b = f"blocks.{i}."
        out += [(b + "ln1", (d,), 0.0),
                (b + "attn.wq", (d, H, Dh), 0.02),
                (b + "attn.wk", (d, K, Dh), 0.02),
                (b + "attn.wv", (d, K, Dh), 0.02),
                (b + "attn.wo", (H, Dh, d), 0.02),
                (b + "ln2", (d,), 0.0)]
        if s.moe:
            E = s.n_experts
            out += [(b + "moe.router", (d, E), 0.02),
                    (b + "moe.wi_gate", (E, d, F), 0.02),
                    (b + "moe.wi_up", (E, d, F), 0.02),
                    (b + "moe.wo", (E, F, d), 0.02)]
        else:
            out += [(b + "mlp.wi_gate", (d, F), 0.02),
                    (b + "mlp.wi_up", (d, F), 0.02),
                    (b + "mlp.wo", (F, d), 0.02)]
    out += [("final_norm", (d,), 0.0), ("lm_head", (d, s.vocab), 0.02)]
    return out


def chunk_seed(seed: int, leaf: int, chunk: int) -> int:
    state = np.random.SeedSequence([seed, _TAG, leaf, chunk]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def chunks(n: int) -> list:
    return [(lo, min(n, lo + CHUNK)) for lo in range(0, n, CHUNK)]


@torch.no_grad()
def draw_chunk(out: torch.Tensor, seed: int, leaf: int, chunk: int,
               scale: float, gen: torch.Generator) -> torch.Tensor:
    """Fill the flat f32 view `out` with chunk `chunk` of leaf `leaf`."""
    if scale == 0.0:
        return out.zero_()
    gen.manual_seed(chunk_seed(seed, leaf, chunk))
    out.normal_(generator=gen)
    if scale != 1.0:
        out.mul_(scale)
    return out


@torch.no_grad()
def fill(t: torch.Tensor, seed: int, leaf: int, scale: float,
         gen: torch.Generator) -> torch.Tensor:
    """Leaf `leaf` drawn into the contiguous f32 tensor `t`."""
    flat = t.view(-1)
    for c, (lo, hi) in enumerate(chunks(flat.numel())):
        draw_chunk(flat[lo:hi], seed, leaf, c, scale, gen)
    return t


def generator(device) -> torch.Generator:
    return torch.Generator(device=torch.device(device))


def make(s: ModelShape, seed: int, device) -> dict:
    """{name: f32 tensor} of every leaf."""
    gen = generator(device)
    return {name: fill(torch.empty(shape, dtype=torch.float32, device=device),
                       seed, i, scale, gen)
            for i, (name, shape, scale) in enumerate(leaves(s))}


def probe_seed(seed: int, leaf: int, chunk: int, probe: int) -> int:
    state = np.random.SeedSequence(
        [seed, _PROBE_TAG, leaf, chunk, probe]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


@torch.no_grad()
def change_readings(current: dict, s: ModelShape, seed: int) -> tuple:
    """({name: ||current[name] - initial||}, {name: [PROBES projections
    of that change]}), the initial leaf drawn again a chunk at a time.

    The projections are onto N(0, 1) directions drawn from (seed, leaf,
    chunk, probe), the same on both sides of a comparison: for two
    changes a and b of a leaf, ||proj a - proj b|| / ||proj b|| estimates
    ||a - b|| / ||b|| (Johnson-Lindenstrauss), which sees the direction
    of a change that its norm does not."""
    norms, probes = {}, {}
    gen, buf, rnd = None, None, None
    for i, (name, shape, scale) in enumerate(leaves(s)):
        flat = current[name].detach().reshape(-1)
        if gen is None:
            gen = generator(flat.device)
        total = torch.zeros((), dtype=torch.float64, device=flat.device)
        proj = torch.zeros(PROBES, dtype=torch.float64, device=flat.device)
        for c, (lo, hi) in enumerate(chunks(flat.numel())):
            if buf is None or buf.numel() < hi - lo:
                buf = torch.empty(min(CHUNK, flat.numel()),
                                  dtype=torch.float32, device=flat.device)
                rnd = torch.empty_like(buf)
            p0 = draw_chunk(buf[:hi - lo], seed, i, c, scale, gen)
            diff = flat[lo:hi].to(torch.float32) - p0
            total += torch.sum(diff * diff, dtype=torch.float64)
            r = rnd[:hi - lo]
            for j in range(PROBES):
                gen.manual_seed(probe_seed(seed, i, c, j))
                r.normal_(generator=gen)
                proj[j] += torch.sum(diff * r, dtype=torch.float64)
        norms[name] = float(torch.sqrt(total))
        probes[name] = proj.tolist()
    return norms, probes
