"""Mamba2 block (SSD, state-space duality) for the ssm and hybrid
families; counterpart of `repro.models.mamba2` [arXiv:2405.21060].

Prefill and training use the SSD chunked algorithm: within chunks of Q
positions the quadratic, attention-like form, across chunks a linear
recurrence of (H, P, N) states. Decode carries (conv_x, conv_B, conv_C,
ssm) states per layer and costs the same for every token. As in the
reference, z, x, B, C and dt have separate projections.

Shapes: d_inner = expand * d_model; H = d_inner / head_dim SSD heads;
P = head_dim; N = d_state; G = n_groups (B and C shared by the heads of a
group; every config has G = 1). Plain torch, op for op in the
reference's types: projections and the conv in the compute type, dt, A,
the scan and the states in f32. `ssd_reference` is the recurrent oracle
the tests hold `ssd_chunked` against; the reference's `_rms` is
`layers.rms_norm`. The reference computes all of this with XLA, not with
a Pallas kernel.

Under a plan (DTensor parameters, `sharding.planner`), as the reference
shards it: z, x and dt are column-parallel (d_inner and the heads on
"model"), B and C are whole on every rank (every head reads them), the
conv runs on each rank's channels and the SSD core on each rank's
batch rows and heads after the `constrain` of the head inputs (both as
plain torch on local shards, `planner.on_shards`: DTensor's op-by-op choices
over the ~500 ops of a chunk loop would move shards about, and its
dispatch would cost more than the ops), the gated norm's mean over
d_inner is a partial sum across its ranks, and out_proj is
row-parallel. Decode keeps each state in the
placements its cache has (`Plan.cache_spec_tree`): the conv step runs in
its state's layout, and the ssm update on each rank's shard of the
(B, H, P, N) state (`_ssm_step_sharded`), so that no state is gathered.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import is_dtensor
from ..sharding.planner import (constrain, on_shards, reduce_partial,
                                replicate_like, unshard)
from .layers import rms_norm, weight
from .param import normal


def dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.head_dim
    return d_inner, H, s.head_dim, s.d_state, s.n_groups


def init_mamba_block(cfg, dtype, generator=None, device=None):
    """One layer's parameters, in the reference's leaves and types: the
    norms, biases, `D` and `dt_bias` as in the reference (zeros or ones),
    `A_log` = log(linspace(1, 16, H)), the rest scale 0.02 normals drawn
    from `generator`."""
    s = cfg.ssm
    d_inner, H, P, N, G = dims(cfg)
    GN = G * N
    kw = dict(dtype=dtype, generator=generator, device=device)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=device)

    return {
        "ln": zeros(cfg.d_model),
        "in_z": normal((cfg.d_model, d_inner), **kw),
        "in_x": normal((cfg.d_model, d_inner), **kw),
        "in_B": normal((cfg.d_model, GN), **kw),
        "in_C": normal((cfg.d_model, GN), **kw),
        "in_dt": normal((cfg.d_model, H), **kw),
        "conv_x": normal((s.conv_width, d_inner), **kw),
        "conv_B": normal((s.conv_width, GN), **kw),
        "conv_C": normal((s.conv_width, GN), **kw),
        "conv_x_b": zeros(d_inner),
        "conv_B_b": zeros(GN),
        "conv_C_b": zeros(GN),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=device)).to(
            dtype),
        "D": torch.ones((H,), dtype=dtype, device=device),
        "dt_bias": zeros(H),
        "norm": zeros(d_inner),
        "out_proj": normal((d_inner, cfg.d_model), **kw),
    }


def zero_states(cfg, batch: int, device=None):
    """The (conv_x, conv_B, conv_C, ssm) state of one layer before any
    token (the reference's `_mamba_state_spec` shapes and types): the last
    W - 1 pre-conv inputs in bf16 and the (B, H, P, N) f32 state."""
    d_inner, H, Pd, N, G = dims(cfg)
    W = cfg.ssm.conv_width
    bf16 = dict(dtype=torch.bfloat16, device=device)
    return (torch.zeros((batch, W - 1, d_inner), **bf16),
            torch.zeros((batch, W - 1, G * N), **bf16),
            torch.zeros((batch, W - 1, G * N), **bf16),
            torch.zeros((batch, H, Pd, N), dtype=torch.float32,
                        device=device))


def _conv_full(x, w, b):
    """Causal depthwise conv over (B, S, C): W taps summed in tap order
    over the left-padded input, as the reference sums them (no
    `F.conv1d`, whose cuDNN path may use TF32 on the card)."""
    W, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    for i in range(W):
        out = out + pad[:, i: i + S] * w[i]
    return F.silu(out + b)


def _conv_step(state, new_col, w, b):
    """Decode conv: state (B, W-1, C) (cast to the new column's type),
    new_col (B, 1, C) -> (out (B, C), state (B, W-1, C)). A DTensor state
    keeps its placements: the new column is cut to them (no collective)
    and the weights follow."""
    if is_dtensor(state):
        new_col = new_col.redistribute(state.device_mesh, state.placements)
    window = torch.cat([state.to(new_col.dtype), new_col], dim=1)
    out = torch.einsum("bwc,wc->bc", window, w) + b
    return F.silu(out), window[:, 1:]


def _gated_norm(y, z, w, eps):
    """RMS norm of y * silu(z) over d_inner, scaled by (1 + w); a DTensor
    y sharded on d_inner by `_gated_norm_sharded`."""
    if is_dtensor(y) and any(p.is_shard(y.dim() - 1) for p in y.placements):
        return _gated_norm_sharded(y, z, w, eps)
    y = y * F.silu(z.to(torch.float32)).to(y.dtype)
    yf = y.to(torch.float32)
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    return ((yf * torch.rsqrt(var + eps)) * (1.0 + w.to(torch.float32))
            ).to(y.dtype)


def _gated_norm_sharded(y, z, w, eps):
    """`_gated_norm` of DTensors y and z sharded on d_inner, on each
    rank's shards (`on_shards`): each rank gates its channels and sums
    their squares over d_inner, a partial sum across the channels' ranks
    reduced by an all-reduce of (B, S, 1), then scales its own
    channels."""
    n = y.shape[-1]

    def gate(y, z):
        g = y * F.silu(z.to(torch.float32)).to(y.dtype)
        gf = g.to(torch.float32)
        return g, torch.sum(gf * gf, dim=-1, keepdim=True) / n

    def scale(g, ms, w):
        gf = g.to(torch.float32)
        return ((gf * torch.rsqrt(ms + eps)) * (1.0 + w.to(torch.float32))
                ).to(g.dtype)

    dims = (0, 1, 2)
    g, ms = on_shards(gate, [(y, dims), (z, dims)], [dims, (0, 1, None)])
    return on_shards(scale, [(g, dims), (reduce_partial(ms), (0, 1, None)),
                             (w, (2,))], [dims])


# ---------------------------------------------------------------------------
# SSD core: chunked (prefill and training) and the recurrent oracle
# ---------------------------------------------------------------------------


def ssd_chunked(xh, dt, A, Bc, Cc, chunk, h0=None,
                intra_dtype=torch.float32):
    """SSD over a full sequence.

    xh: (B, S, H, P) head inputs; dt: (B, S, H) softplus'd steps; A: (H,)
    negative; Bc, Cc: (B, S, N) (G == 1, shared by every head). S must be
    a multiple of `chunk` or below it (one chunk of S). Returns
    (y (B, S, H, P) in xh's type, h_final (B, H, P, N) f32): the
    intra-chunk part (`_ssd_intra`) plus the part carried across chunks
    (`_ssd_chunk_scan`)."""
    Bsz, S, H, Pd = xh.shape
    N = Bc.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"ssd_chunked: the sequence length {S} must be a "
                         f"multiple of the SSD chunk {chunk} or below it")
    nc = S // Q
    f32 = torch.float32
    dtc = dt.reshape(Bsz, nc, Q, H).to(f32)
    Bcc = Bc.reshape(Bsz, nc, Q, N).to(f32)
    Ccc = Cc.reshape(Bsz, nc, Q, N).to(f32)
    dtx = xh.reshape(Bsz, nc, Q, H, Pd).to(f32) * dtc[..., None]
    cs = torch.cumsum(dtc * A.to(f32), dim=2)             # inclusive, < 0
    y_intra = _ssd_intra(cs, Ccc, Bcc, dtx, intra_dtype)
    y_inter, h = _ssd_chunk_scan(cs, Ccc, Bcc, dtx, h0)
    y = (y_intra + y_inter).reshape(Bsz, S, H, Pd).to(xh.dtype)
    return y, h


def _ssd_intra(cs, Ccc, Bcc, dtx, intra_dtype):
    """Within each chunk, y_i = sum_{j <= i} M[i, j] (C_i . B_j) dtx_j
    with M[i, j] = exp(cs_i - cs_j): (B, nc, Q, H, P) f32. cs (B, nc, Q,
    H) is the inclusive cumsum of dt A over the chunk; the upper triangle
    is -inf before the exp, so it is 0 with no inf anywhere. M and its
    product with C . B are (B, nc, H, Q, Q) f32, the largest tensors of
    the layer; the product with dtx is a batched matmul over (B, nc,
    H)."""
    Q = cs.shape[2]
    csh = cs.transpose(2, 3)                              # (B,nc,H,Q)
    upper = replicate_like(torch.ones((Q, Q), dtype=torch.bool,
                                      device=cs.device).triu(1), cs)
    M = torch.exp((csh[..., :, None] - csh[..., None, :]).masked_fill(
        upper, float("-inf")))                            # (B,nc,H,Q,Q)
    CB = torch.einsum("bcin,bcjn->bcij", Ccc.to(intra_dtype),
                      Bcc.to(intra_dtype))                # (B,nc,Q,Q)
    MCB = M.to(intra_dtype) * CB[:, :, None]
    del M
    y = torch.matmul(MCB, dtx.transpose(2, 3).to(intra_dtype))
    return y.to(torch.float32).transpose(2, 3)            # (B,nc,Q,H,P)


def _ssd_chunk_scan(cs, Ccc, Bcc, dtx, h0=None):
    """What crosses chunk boundaries: each chunk's end state S_c = sum_j
    exp(cs_last - cs_j) B_j (x) dtx_j, the recurrence h_c = exp(cs_last)
    h_{c-1} + S_c over the chunks from h0 (zeros if None), and the
    contribution of the state entering each chunk, C_i h_{c-1}
    exp(cs_i). Returns (y_inter (B, nc, Q, H, P), h_final (B, H, P, N)),
    f32."""
    Bsz, nc, Q, H, Pd = dtx.shape
    decay_end = torch.exp(cs[:, :, -1:, :] - cs)          # (B,nc,Q,H)
    states = torch.einsum("bcjhp,bcjn->bchpn", dtx * decay_end[..., None],
                          Bcc)                            # (B,nc,H,P,N)
    chunk_decay = torch.exp(cs[:, :, -1, :])              # (B,nc,H)
    h = torch.zeros_like(states[:, 0]) if h0 is None else h0
    h_prev = []                                           # entering chunk c
    for c in range(nc):
        h_prev.append(h)
        h = chunk_decay[:, c, :, None, None] * h + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                   # (B,nc,H,P,N)
    y = torch.einsum("bcin,bchpn->bcihp", Ccc, h_prev) \
        * torch.exp(cs)[..., None]
    return y, h


def ssd_reference(xh, dt, A, Bc, Cc):
    """The naive recurrent oracle, one position at a time, in f32.
    Bc, Cc: (B, S, N). Returns y (B, S, H, P) in xh's type."""
    Bsz, S, H, Pd = xh.shape
    f32 = torch.float32
    a = torch.exp(dt.to(f32) * A.to(f32))                 # (B,S,H)
    Bn, Cn = Bc.to(f32), Cc.to(f32)
    dtx = xh.to(f32) * dt.to(f32)[..., None]
    h = torch.zeros((Bsz, H, Pd, Bc.shape[-1]), dtype=f32, device=xh.device)
    ys = []
    for t in range(S):
        h = a[:, t][:, :, None, None] * h + torch.einsum(
            "bhp,bn->bhpn", dtx[:, t], Bn[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cn[:, t]))
    return torch.stack(ys, dim=1).to(xh.dtype)


# ---------------------------------------------------------------------------
# DTensor programs: the conv and the SSD core on each rank's shards
# ---------------------------------------------------------------------------


def conv_full(x, w, b):
    """`_conv_full`; on a DTensor x (B, S, C) on each rank's batch rows
    and channels, the weights (W, C) and (C,) cut to its channels."""
    if not is_dtensor(x):
        return _conv_full(x, w, b)
    return on_shards(_conv_full, [(x, (0, 1, 2)), (w, (None, 2)), (b, (2,))],
                     [(0, 1, 2)])


def ssd(xh, dt, A, Bc, Cc, chunk, intra_dtype):
    """`ssd_chunked`; on a DTensor xh (B, S, H, P) on each rank's batch
    rows and heads, dt (B, S, H) and A (H,) cut alike, B and C (B, S, N)
    to its rows (their gradients partial sums over the heads' ranks)."""
    if not is_dtensor(xh):
        return ssd_chunked(xh, dt, A, Bc, Cc, chunk,
                           intra_dtype=intra_dtype)
    return on_shards(
        lambda *a: ssd_chunked(*a, chunk, intra_dtype=intra_dtype),
        [(xh, (0, 1, 2, 3)), (dt, (0, 1, 2)), (A, (2,)), (Bc, (0, 1, None)),
         (Cc, (0, 1, None))], [(0, 1, 2, 3), (0, 2, 3, None)])


# ---------------------------------------------------------------------------
# Block-level apply
# ---------------------------------------------------------------------------


#: each input projection's tensor-parallel dims, which a DTensor weight
#: keeps sharded (`layers.weight`): d_inner for z and x, the heads for
#: dt; B and C are shared by every head, so gathered whole
_PROJ_KEEP = {"in_z": (1,), "in_x": (1,), "in_B": (), "in_C": (),
              "in_dt": (1,)}
#: the same for the conv weights and biases
_CONV_KEEP = {"x": ((1,), (0,)), "B": ((), ()), "C": ((), ())}


def _project(p, hn):
    """The input projections: (z, x, B, C, dt raw), each hn @ W in hn's
    type."""
    return tuple(hn @ weight(p[k], hn, keep) for k, keep in
                 _PROJ_KEEP.items())


def _conv_weights(p, name, x):
    """(w, b) of the conv of `name` ("x", "B" or "C") in x's type."""
    kw, kb = _CONV_KEEP[name]
    return weight(p[f"conv_{name}"], x, kw), weight(p[f"conv_{name}_b"], x,
                                                     kb)


def _heads(p, key):
    """A (H,) parameter (A_log, D, dt_bias) with its heads' shards."""
    return unshard(p[key], (0,))


def _out_proj(p, y, x):
    """Row-parallel: a DTensor y sharded on d_inner gives a partial sum,
    reduced into the layout of the residual `x` it is added to (as the
    reference's residual keeps its input's sharding)."""
    out = y @ weight(p["out_proj"], y, (0,))
    if is_dtensor(out) and tuple(out.placements) != tuple(x.placements):
        out = out.redistribute(x.device_mesh, x.placements)
    return out


def apply_mamba_full(p, x, cfg):
    """Prefill and training. x: (B, S, D) -> (x + out, states), states =
    (conv_x, conv_B, conv_C: the last W - 1 pre-conv inputs in bf16,
    ssm (B, H, P, N) f32)."""
    s = cfg.ssm
    d_inner, H, Pd, N, G = dims(cfg)
    dtype = x.dtype
    hn = rms_norm(x, p["ln"], cfg.norm_eps)
    z, xin, Bc, Cc, dtr = _project(p, hn)
    W = s.conv_width
    # copies: a view would keep the whole (B, S, C) input alive
    st = tuple(c[:, -(W - 1):].to(torch.bfloat16, copy=True)
               for c in (xin, Bc, Cc))
    xin = conv_full(xin, *_conv_weights(p, "x", xin))
    Bc = conv_full(Bc, *_conv_weights(p, "B", Bc))
    Cc = conv_full(Cc, *_conv_weights(p, "C", Cc))
    dt = F.softplus(dtr.to(torch.float32)
                    + _heads(p, "dt_bias").to(torch.float32))
    A = -torch.exp(_heads(p, "A_log").to(torch.float32))
    xh = xin.reshape(*xin.shape[:2], H, Pd)
    xh = constrain(xh, ("batch", None, "ssm_heads", None))
    y, h_final = ssd(xh, dt, A, Bc, Cc, s.chunk,
                     getattr(torch, s.intra_dtype))
    y = y + xh * _heads(p, "D").to(dtype)[:, None]
    y = y.reshape(*y.shape[:2], d_inner)
    y = _gated_norm(y, z, unshard(p["norm"], (0,)), cfg.norm_eps)
    out = _out_proj(p, y, x)
    return x + out, st + (h_final,)


def _ssm_step(h, a, dtx, Bo, Co):
    """One token of the recurrence, f32: h (B, H, P, N) decayed by a
    (B, H) plus dtx (B, H, P) (x) Bo (B, N); y = h . Co (B, H, P)."""
    h = a[:, :, None, None] * h + torch.einsum("bhp,bn->bhpn", dtx, Bo)
    return h, torch.einsum("bhpn,bn->bhp", h, Co)


def _ssm_step_sharded(h, a, dtx, Bo, Co):
    """`_ssm_step` on each rank's shard of a DTensor state h, which keeps
    its placements (the cache's: its batch on the batch axes, N or the
    heads on "model"): a, dtx, Bo and Co cut to the matching dims (a
    gather of the small ones where h shards a dim they lack), and y, a
    sum over N, a partial sum over the mesh dims that shard N, reduced
    here (an all-reduce of (B, H, P))."""
    h, y = on_shards(_ssm_step, [(h, (0, 1, 2, 3)), (a, (0, 1)),
                                 (dtx, (0, 1, 2)), (Bo, (0, 3)),
                                 (Co, (0, 3))], [(0, 1, 2, 3), (0, 1, 2)])
    return h, reduce_partial(y)


def apply_mamba_decode(p, x, states, cfg):
    """One-token decode. x: (B, 1, D); states = (conv_x (B, W-1, d_inner),
    conv_B (B, W-1, GN), conv_C (B, W-1, GN), ssm (B, H, P, N) f32).
    Returns (x + out, new states), the conv states stored in bf16."""
    d_inner, H, Pd, N, G = dims(cfg)
    dtype = x.dtype
    conv_x, conv_B, conv_C, ssm_state = states
    hn = rms_norm(x, p["ln"], cfg.norm_eps)
    z, xin, Bc, Cc, dtr = _project(p, hn)
    xo, conv_x = _conv_step(conv_x, xin, *_conv_weights(p, "x", xin))
    Bo, conv_B = _conv_step(conv_B, Bc, *_conv_weights(p, "B", Bc))
    Co, conv_C = _conv_step(conv_C, Cc, *_conv_weights(p, "C", Cc))
    f32 = torch.float32
    dt = F.softplus(dtr.to(f32) + _heads(p, "dt_bias").to(f32))  # (B,1,H)
    A = -torch.exp(_heads(p, "A_log").to(f32))
    a = torch.exp(dt[:, 0] * A)                           # (B,H)
    xh = xo.reshape(-1, H, Pd).to(f32)
    dtx = xh * dt[:, 0][..., None]
    step = _ssm_step_sharded if is_dtensor(ssm_state) else _ssm_step
    h, y = step(ssm_state, a, dtx, Bo.to(f32), Co.to(f32))
    if is_dtensor(y):
        xh = xh.redistribute(y.device_mesh, y.placements)
    y = y + xh * _heads(p, "D").to(f32)[:, None]
    y = y.reshape(-1, 1, d_inner).to(dtype)
    y = _gated_norm(y, z, unshard(p["norm"], (0,)), cfg.norm_eps)
    out = _out_proj(p, y, x)
    new_states = (conv_x.to(torch.bfloat16), conv_B.to(torch.bfloat16),
                  conv_C.to(torch.bfloat16), h)
    return x + out, new_states
