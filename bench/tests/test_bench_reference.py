"""The reference against the port's plain path at a tiny size on the
CPU, both in float32: the same loss and gradients from the same weights
and tokens. (This test may import both; the reference may not.)"""
import dataclasses

import pytest
import torch

from bench.lib import tokens as T
from bench.lib import weights as W
from bench.lib.model_shape import shape_of
from bench.lib.train import load_weights, named_leaves, program_config
from bench.reference import transformer as R
from conftest import tiny


@pytest.mark.parametrize("name", ["mistral-nemo-12b", "olmoe-1b-7b"])
def test_reference_matches_the_port_in_float32(name):
    from repro_torch.models import model as model_lib
    cfg = tiny(name)
    s = shape_of(cfg)
    pc = dataclasses.replace(program_config(cfg), compute_dtype="float32",
                             remat="none")
    model = model_lib.build(pc)
    params = model.init(seed=0, device="cpu")
    load_weights(params, s, 99)
    batch = T.step_batch(99, 0, s.vocab, 32, 2, 2)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    leaves = {n: p.requires_grad_(True)
              for n, p in named_leaves(params).items()}
    loss, _ = model.loss_fn(params, tb)
    loss.backward()

    P = W.make(s, 99, "cpu")
    for p in P.values():
        p.requires_grad_(True)
    allowed = torch.ones((32, 32), dtype=torch.bool).tril_()
    prec = R.Precision("float32")
    ref_loss = sum(R.row_step(P, tb["tokens"][r].long(),
                              tb["labels"][r].long(), s, prec, allowed, 0.5)
                   for r in range(2)) / 2
    assert ref_loss == pytest.approx(float(loss.detach()), rel=1e-5)
    for n, p in P.items():
        torch.testing.assert_close(p.grad, leaves[n].grad, rtol=1e-4,
                                   atol=1e-6, msg=n)


def test_experts_drop_past_capacity():
    """At the tiny size some (token, slot) pairs overflow their expert:
    the reference keeps exactly the first `capacity` of each expert in
    slot-major order."""
    s = shape_of(tiny("olmoe-1b-7b"))
    S, E, K = 32, s.n_experts, s.top_k
    g = torch.Generator().manual_seed(0)
    probs = torch.softmax(torch.randn(S, E, generator=g) * 3, -1)
    _, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    idx = idx[:, :K]
    flat = idx.t().reshape(-1)
    seen = {}
    kept = 0
    for e in flat.tolist():
        seen[e] = seen.get(e, 0) + 1
        kept += seen[e] <= s.capacity(S)
    assert kept < S * K          # the case drops some
    onehot = torch.nn.functional.one_hot(flat, E)
    place = ((torch.cumsum(onehot, 0) - 1) * onehot).sum(-1)
    assert int((place < s.capacity(S)).sum()) == kept


def test_float8_products_round():
    x = torch.randn(64, 64, generator=torch.Generator().manual_seed(1))
    q = R.Precision("float8")
    y = q.mm(x, x)
    assert not torch.equal(y, x @ x)
    assert torch.allclose(y, x @ x, rtol=0.3, atol=2.0)


@pytest.mark.parametrize("steps", [1, 2, 3])
def test_reference_adamw_is_torchs(steps):
    """The reference's AdamW (g1 kept in place of the moments until step
    2) against `torch.optim.AdamW`, step for step."""
    g = torch.Generator().manual_seed(3)
    P = {"a": torch.randn(5, 7, generator=g), "b": torch.randn(11,
                                                               generator=g)}
    Q = {k: v.clone().requires_grad_(True) for k, v in P.items()}
    grads = [{k: torch.randn(v.shape, generator=g) for k, v in P.items()}
             for _ in range(steps)]
    opt = torch.optim.AdamW(Q.values(), lr=1e-2, betas=(0.9, 0.95),
                            eps=1e-8, weight_decay=0.0)
    state = {}
    for t, gr in enumerate(grads, start=1):
        for k in P:
            P[k].grad = gr[k].clone()
            Q[k].grad = gr[k].clone()
        R.adamw(P, state, t, 1e-2, 0.9, 0.95, 1e-8, last=t == steps)
        opt.step()
        for k in P:
            torch.testing.assert_close(P[k], Q[k].detach(), rtol=1e-6,
                                       atol=1e-7)
