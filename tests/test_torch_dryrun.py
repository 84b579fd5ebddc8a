"""The port's dry run (`repro_torch.launch.dryrun`), op analyzer
(`launch/op_analyzer.py`) and roofline (`launch/roofline.py`) on the
CPU, on fake tensors, against the JAX package's formulas.

Full width appears once: gemma2-2b's train_4k cell on one card
(`device="cpu"`), a fake trace of one microbatch (4 x 4096), counted 64
times plus the update. Its dot FLOPs are about 1.33x
`model_flops_analytic`, within [1.0, 1.6]: the analytic figure counts
each parameter (the lm-head among them, the embedding table left out)
6 times a token and the attention products over the causal half (S/2 a
token), while the trace also counts (1) remat's recompute of every
block's forward in the backward (8 FLOPs a block parameter and token,
not 6: about 0.24 of the analytic figure) and (2) the attention
backward, one operator costed at its kernel's nine products over the
causal pairs (about 0.12). On a `reduced()` config the vocabulary's
head dominates, so no ratio is held there.
"""
import contextlib
import gzip
import json
import math
import os

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import ALL_ARCHS, SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro.configs import shape_applicable as ref_applicable
from repro.launch import roofline as ref_roofline
from repro.launch.hlo_analyzer import analyze as ref_analyze
from repro_torch.ckpt.checkpoint import tree_leaves
from repro_torch.configs import SHAPES, get_config, shape_applicable
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.op_analyzer import (BWD_PRODUCTS, FLASH_BWD_OP,
                                            FLASH_OP, OpAnalyzer,
                                            allowed_pairs, cost, records_of,
                                            summary_of)
from repro_torch.models import model as model_lib
from repro_torch.models.inputs import batch_struct, make_batch
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.train_step import TrainState


@pytest.fixture(scope="module")
def ref_dryrun():
    """The reference's dry-run module; its import sets XLA_FLAGS for 512
    host devices, which must not reach a later jax start-up here."""
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as mod
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return mod


@pytest.mark.parametrize("name", ALL_ARCHS)
def test_model_flops_and_microbatches_match_reference(name, ref_dryrun):
    for shape in SHAPES:
        assert dryrun.model_flops_analytic(get_config(name), shape) == \
            pytest.approx(ref_dryrun.model_flops_analytic(ref_config(name),
                                                          shape), rel=1e-12)
    for batch in (256, 128, 32):
        for div in (1, 2, 16, 32):
            assert dryrun.n_microbatches(name, batch, div) == \
                ref_dryrun.n_microbatches(name, batch, div)
    assert dryrun.PER_DEVICE_MICRO == ref_dryrun.PER_DEVICE_MICRO


def test_shape_grid_matches_reference():
    assert SHAPES == REF_SHAPES
    grid = {(a, s): shape_applicable(a, s) for a in ALL_ARCHS for s in SHAPES}
    assert grid == {(a, s): ref_applicable(a, s) for a in ALL_ARCHS
                    for s in SHAPES}
    assert sum(ok for ok, _ in grid.values()) == 31


def _train_step(m, params, batch):
    loss, _ = m.loss_fn(params, batch)
    loss.backward()


def _grad_params(m):
    params = m.init(seed=0, device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return params


def test_analyzer_flops_match_flop_counter():
    """Reduced gemma2-2b's loss and backward on the CPU: each contraction
    costs what FlopCounterMode gives it (the flash-attention entry is
    the analyzer's own: FlopCounterMode does not know the operator)."""
    cfg = get_config("gemma2-2b").reduced()
    m = model_lib.build(cfg)
    params = _grad_params(m)
    batch = make_batch(cfg, 2, 64, "train", device="cpu")
    with OpAnalyzer() as an:
        _train_step(m, params, batch)
    with FlopCounterMode(display=False) as fc:
        _train_step(m, params, batch)
    want = {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}
    got: dict = {}
    for sig, count in an.records.items():
        base = sig[0].split(".")[1]
        if base in ("mm", "bmm", "addmm", "baddbmm"):
            got["aten." + base] = got.get("aten." + base, 0) + \
                count * cost(sig)["flops"]
    assert got and got == {k: want[k] for k in got}
    assert set(want) <= set(got)
    s = an.summary()
    assert s["flash_attention_entries"] == 2 * cfg.n_layers   # + remat
    assert s["dot_flops"] > sum(got.values())


def test_bytes_rules():
    x = torch.randn(64, 32)
    y = torch.randn(64, 32)
    idx = torch.arange(8)
    with OpAnalyzer() as an:
        z = x + y                       # 3 x 8192 bytes
        x.t().reshape(-1).view(32, 64)  # views: 0
        z.add_(y)                       # read z, y; write z
        w = torch.empty(64, 32)         # an allocation: 0
        w.copy_(x)                      # read x, write w
        z[idx] = y[:8]                  # index_put_: (indices + values) x 2
    by_op: dict = {}
    for sig, c in an.records.items():
        by_op[sig[0]] = by_op.get(sig[0], 0) + c * cost(sig)["bytes"]
    n = 64 * 32 * 4
    assert by_op["aten.add.Tensor"] == 3 * n
    assert by_op["aten.add_.Tensor"] == 3 * n
    assert by_op["aten.t.default"] == by_op["aten.view.default"] == 0
    assert by_op["aten.empty.memory_format"] == 0
    assert by_op["aten.copy_.default"] == 2 * n
    assert by_op["aten.index_put_.default"] == 2 * (8 * 8 + 8 * 32 * 4)
    assert an.summary()["dot_flops"] == 0


@pytest.mark.parametrize("mask", [
    dict(causal=True), dict(causal=True, window=9),
    dict(causal=True, prefix_len=20), dict(causal=False),
    dict(causal=False, window=5), dict(causal=True, window=7, prefix_len=12)])
def test_flash_attention_is_one_entry(mask):
    """One entry a call on real and on fake tensors, costed over the
    pairs the mask allows; the plain version's ops are not seen."""
    B, H, K, S, D = 2, 4, 2, 48, 16
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(B, n, S, D, generator=g) for n in (H, K, K))
    pairs = allowed_pairs(S, S, **mask)
    m = fa.allowed_mask(S, S, mask["causal"], mask.get("window"),
                        mask.get("prefix_len", 0))
    assert pairs == (S * S if m is None else int(m.sum()))
    for fake in (False, True):
        with FakeTensorMode() if fake else torch.no_grad():
            args = [torch.empty(t.shape) for t in (q, k, v)] if fake \
                else (q, k, v)
            with OpAnalyzer() as an:
                fa.attention(*args, softcap=30.0, **mask)
        s = an.summary()
        assert s["op_counts"] == {FLASH_OP: 1}, s["op_counts"]
        assert s["dot_flops"] == 4 * B * H * D * pairs
        assert s["hbm_bytes"] == 4 * (2 * B * H * S * D + 2 * B * K * S * D)


@pytest.mark.parametrize("mask", [
    dict(causal=True), dict(causal=True, window=9),
    dict(causal=True, prefix_len=20), dict(causal=False),
    dict(causal=False, window=5), dict(causal=True, window=7, prefix_len=12)])
def test_flash_attention_backward_is_one_entry(mask):
    """Under autograd, one forward and one backward entry a call on real
    and on fake tensors: the backward costed at its kernel's products
    (`BWD_PRODUCTS` of 2 B H D a pair the mask allows) and the bytes of
    q, k, v and dO read and dq, dk and dv written."""
    B, H, K, S, D = 2, 4, 2, 48, 16
    g = torch.Generator().manual_seed(1)
    q, k, v, dout = (torch.randn(B, n, S, D, generator=g)
                     for n in (H, K, K, H))
    pairs = allowed_pairs(S, S, **mask)
    for fake in (False, True):
        with FakeTensorMode() if fake else contextlib.nullcontext():
            args = [torch.empty(t.shape) for t in (q, k, v, dout)] if fake \
                else [q, k, v, dout]
            leaves = [x.requires_grad_(True) for x in args[:3]]
            with OpAnalyzer() as an:
                out = fa.attention(*leaves, softcap=30.0, **mask)
                torch.autograd.grad(out, leaves, args[3])
        s = an.summary()
        assert s["op_counts"] == {FLASH_OP: 1, FLASH_BWD_OP: 1}, \
            s["op_counts"]
        assert s["flash_attention_backward_entries"] == 1
        assert BWD_PRODUCTS == 13
        assert s["dot_flops"] == (4 + 2 * BWD_PRODUCTS) * B * H * D * pairs
        assert s["hbm_bytes"] == 4 * S * D * (
            (2 * B * H + 2 * B * K) + (3 * B * H + 4 * B * K))


def _micro_trace(cfg, batch=1, seq=32, n_micro=2):
    """One train step of `n_micro` microbatches of batch x seq traced on
    fake CPU tensors, as `dryrun.cell` traces a cell."""
    model = model_lib.build(cfg)
    optimizer = make_optimizer(cfg)
    an = OpAnalyzer()
    with FakeTensorMode():
        params = model.init(seed=0, device="cpu")
        state = TrainState(params, optimizer.init(params),
                           torch.zeros((), dtype=torch.int32))
        dryrun.trace_train(model, optimizer, state,
                           batch_struct(cfg, batch, seq, "train", "cpu"),
                           n_micro, an)
    return an.records


@pytest.mark.parametrize("name", ["gemma2-2b", "olmoe-1b-7b"])
def test_remat_dots_and_blockattn_options(name):
    """The reference's options: `remat_dots` sets remat="dots", and its
    trace counts fewer FLOPs than the default by exactly the forward
    FLOPs of the blocks' weight products (q, k, v, o and the MLP's three,
    or moe's router; the experts' bmm is recomputed); `blockattn` sets
    attn_impl="blocked" and gives the default's records, op for op
    (traced for gemma2-2b: attn_impl reaches the attention alone)."""
    base = get_config(name).reduced()
    dots = dryrun._apply_cfg_opts(base, {"remat_dots"})
    blocked = dryrun._apply_cfg_opts(base, {"blockattn"})
    assert (dots.remat, blocked.attn_impl) == ("dots", "blocked")
    records = {"full": _micro_trace(base), "dots": _micro_trace(dots)}
    if name == "gemma2-2b":
        assert _micro_trace(blocked) == records["full"]
    per_token = base.d_model * base.head_dim * (
        2 * base.n_heads + 2 * base.n_kv_heads)
    per_token += base.d_model * base.moe.n_experts if base.moe else \
        3 * base.d_model * base.d_ff
    tokens = 1 * 32 * 2
    saved = 2.0 * per_token * tokens * base.n_layers
    flops = {k: summary_of(r.items())["dot_flops"]
             for k, r in records.items()}
    assert flops["full"] - flops["dots"] == saved
    assert summary_of(records["dots"].items())[
        "flash_attention_backward_entries"] == 2 * base.n_layers


HLO = """HloModule m

ENTRY %main (p0: f32[4,8]) -> f32[16,8] {{
  %p0 = f32[4,8]{{1,0}} parameter(0)
  ROOT %c = {out} {kind}(f32[4,8]{{1,0}} %p0), replica_groups=[1,4]<=[4], dimensions={{0}}
}}
"""


@pytest.mark.parametrize("kind,fn,out", [
    ("all-gather", "all_gather_into_tensor", (16, 8)),
    ("all-reduce", "all_reduce", (4, 8)),
    ("reduce-scatter", "reduce_scatter_tensor", (1, 8)),
    ("all-to-all", "all_to_all_single", (4, 8))])
def test_collective_wire_bytes_match_reference(kind, fn, out):
    """The ring factors over a group of 4, against the reference's
    analyzer on the same collective in HLO text."""
    txt = HLO.format(out=f"f32[{out[0]},{out[1]}]{{1,0}}", kind=kind)
    want = ref_analyze(txt)["wire_bytes"]
    sig = (f"_c10d_functional.{fn}.default", False,
           (("t", (4, 8), 4, "float32", False, False, 32),),
           (("t", out, 4, "float32", False, False, out[0] * out[1]),), 4)
    assert want > 0 and cost(sig)["wire"] == pytest.approx(want, rel=1e-12)


def test_fake_trace_equals_real_trace():
    """Reduced gemma2-2b: one train step (a microbatch counted 3 times,
    then AdamW) and one decode step, traced on fake tensors and run on
    real ones: the same FLOPs and bytes. (The ops may differ: a fake
    (2, 1, 64) activation's strides send decode's projection through
    `matmul`'s bmm path, expand and bmm, where the real one folds to
    mm; the same work.)"""
    cfg = get_config("gemma2-2b").reduced()
    m = model_lib.build(cfg)
    opt = __import__("repro_torch.train.optimizer",
                     fromlist=["x"]).make_optimizer(cfg)
    from repro_torch.train.train_step import TrainState

    def run(fake):
        with FakeTensorMode() if fake else torch.enable_grad():
            params = m.init(seed=0, device="cpu")
            state = TrainState(params, opt.init(params),
                               torch.zeros((), dtype=torch.int32))
            an = OpAnalyzer()
            dryrun.trace_train(m, opt, state,
                               batch_struct(cfg, 2, 32, "train", "cpu"), 3,
                               an)
            cache = m.init_cache(2, 32, device="cpu")
            dec = OpAnalyzer()
            dryrun.trace_decode(m, params, torch.zeros(
                (2, 1), dtype=torch.int32), cache, dec)
        return an.summary(), dec.summary()

    for real, fake in zip(run(False), run(True)):
        assert real["dot_flops"] == fake["dot_flops"] > 0
        assert real["hbm_bytes"] == fake["hbm_bytes"] > 0


def test_roofline_row_matches_reference(monkeypatch):
    """The same record through both rows, under the reference's three
    constants; the table shows the collective term."""
    monkeypatch.setattr(roofline, "PEAK_FLOPS", ref_roofline.PEAK_FLOPS)
    monkeypatch.setattr(roofline, "HBM_BW", ref_roofline.HBM_BW)
    monkeypatch.setattr(roofline, "NVLINK_BW", ref_roofline.ICI_BW)
    for kind, wire in (("train", 3e10), ("decode", 1e7), ("prefill", 5e12)):
        rec = {"arch": "gemma2-2b", "shape": "x", "mesh": "16x16",
               "n_devices": 256, "kind": kind, "flops_per_device": 4e14,
               "hbm_bytes_per_device": 2e12, "collective_wire_bytes": wire,
               "model_flops": 9e16,
               "memory": {"argument_bytes": 3e9, "temp_bytes": 1e9}}
        got, want = roofline.roofline_row(rec), ref_roofline.roofline_row(rec)
        got["hlo_flops_total"] = got.pop("traced_flops_total")
        got.pop("fits")
        assert got == want
    row = roofline.roofline_row(rec)
    assert row["collective_s"] == pytest.approx(5e12 / roofline.NVLINK_BW)
    assert f"{row['collective_s']:9.4f}" in roofline.table([row])


def test_main_writes_a_cell_that_roofline_reads(tmp_path, capsys):
    """One reduced cell through `dryrun.main`, read back by
    `roofline.main`; `--reanalyze` costs the stored op log again to the
    same numbers."""
    out = tmp_path / "dry"
    args = ["--arch", "chatglm3-6b", "--shape", "decode_32k", "--mesh",
            "h100", "--device", "cpu", "--reduced", "--out", str(out)]
    assert dryrun.main(args) == 0
    path = out / "chatglm3-6b__decode_32k__h100__reduced.json"
    rec = json.loads(path.read_text())
    assert rec["collective_wire_bytes"] == 0 and rec["per_device"] == "trace"
    assert rec["memory"]["temp_bytes"] is None and rec["fits"]
    with gzip.open(out / (path.stem + ".ops.json.gz"), "rt") as f:
        s = summary_of(records_of(json.load(f)))
    assert s["dot_flops"] == rec["flops_per_device"]
    assert dryrun.main(["--reanalyze", "--out", str(out)]) == 0
    assert json.loads(path.read_text())["hbm_bytes_per_device"] == \
        rec["hbm_bytes_per_device"]
    capsys.readouterr()
    assert roofline.main(["--dir", str(out), "--mesh", "h100"]) == 0
    text = capsys.readouterr().out
    assert "chatglm3-6b" in text and "decode_32k" in text and \
        roofline.CARD in text


def test_production_mesh_cell_splits_and_plans():
    """olmoe-1b-7b's train_4k on 16x16 at full width (moe: the kept rows
    at their upper bound under fake tensors), traced sharded as rank 0
    of a fake process group of 256: per-device figures from the trace,
    collective bytes with all-gathers (the parameters' FSDP gathers) and
    reduce-scatters (their gradients'), less work a device than on one
    card, and arguments per device below the whole. (Reduced, no leaf
    reaches the 2^16 elements the plan shards.) A reduced prefill cell
    on the same mesh is traced sharded too: wire bytes, no reason for
    missing ones."""
    one, _ = dryrun.cell("olmoe-1b-7b", "train_4k", "h100", device="cpu",
                         verbose=False)
    rec, _ = dryrun.cell("olmoe-1b-7b", "train_4k", "16x16", device="cpu",
                         verbose=False)
    assert rec["per_device"] == "trace" and rec["n_micro"] == 8
    assert rec["collective_wire_bytes"] > 0
    assert {"all-gather", "reduce-scatter"} <= set(rec["collectives"])
    assert "collective_reason" not in rec
    assert rec["flops_per_device"] < one["flops_per_device"]
    assert rec["flops_total"] == pytest.approx(rec["flops_per_device"] * 256)
    assert rec["memory"]["argument_bytes"] < one["memory"]["argument_bytes"]
    row = roofline.roofline_row(rec)
    assert row["collective_s"] == pytest.approx(
        rec["collective_wire_bytes"] / roofline.NVLINK_BW)
    pre, _ = dryrun.cell("olmoe-1b-7b", "prefill_32k", "16x16",
                         device="cpu", reduced=True, verbose=False)
    assert pre["per_device"] == "trace"
    assert pre["collective_wire_bytes"] > 0
    assert "collective_reason" not in pre


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
def test_sharded_decode_cell_keeps_its_cache(shape):
    """A reduced decode cell on 16x16 whose kv heads (4) do not divide
    "model": `cache_spec_tree` shards the cache's sequence (on "model",
    or on ("data", "model") at long_500k's batch of 1), and the sharded
    trace writes and reads each rank's shard: wire bytes, the
    split-softmax combine's all-reduces, and no collective whose result
    holds a cache leaf's whole extent on a dim the spec shards."""
    rec, log = dryrun.cell("gemma2-2b", shape, "16x16", device="cpu",
                           reduced=True, verbose=False)
    assert rec["per_device"] == "trace" and rec["collective_wire_bytes"] > 0
    assert "all-reduce" in rec["collectives"]
    cfg = get_config("gemma2-2b").reduced()
    seq, batch, _ = SHAPES[shape]
    spec = dryrun.make_plan(cfg, dryrun.MESHES["16x16"]).cache_spec_tree(
        model_lib.build(cfg).init_cache(batch, seq, device="meta"),
        batch)["kv"][0]["k"]
    assert spec[1] == ("model" if batch > 1 else ("data", "model"))
    assert dryrun.cache_gathers("gemma2-2b", shape, "16x16", log,
                                reduced=True) == []
    # the check sees a gathered cache: a log with the cache's sequence
    # all-gathered
    local = (batch // 16 if batch > 1 else 1, seq // 16 if batch > 1
             else seq // 256, cfg.n_kv_heads, cfg.head_dim)
    full = (local[0], seq) + local[2:]
    sig = ("_c10d_functional.all_gather_into_tensor.default", False,
           (("t", local, 2, "bfloat16", False, False, math.prod(local)),
            ("s", 16), ("s", "0")),
           (("t", full, 2, "bfloat16", False, False, math.prod(full)),),
           16)
    assert [g["leaf"] for g in dryrun.cache_gathers(
        "gemma2-2b", shape, "16x16", [[list(sig), 1]], reduced=True)][:1] \
        == ["('kv', 0, 'k')"]


@pytest.mark.parametrize("mesh_kind,opts", [("2x16x16", ()),
                                             ("16x16", ("ep_data",))])
def test_sharded_moe_train_cell(mesh_kind, opts):
    """olmoe-1b-7b's train_4k at full width, traced sharded on the
    2x16x16 mesh (rank 0 of a fake process group of 512) and on 16x16
    with the experts on the data axis (`ep_data`, the plan's token-moving
    expert parallelism): per-device figures from the trace, the
    parameters' all-gathers and their gradients' reduce-scatters, a
    collective term in the roofline. The (E, B*C, D) expert buffers
    cross the data axis (the tokens go to their experts' ranks) under
    ep_data only: otherwise each rank dispatches to its own experts and
    sums partially."""
    from repro_torch.models.moe import _capacity
    cfg = get_config("olmoe-1b-7b")
    rec, log = dryrun.cell("olmoe-1b-7b", "train_4k", mesh_kind,
                           device="cpu", verbose=False, opts=frozenset(opts))
    n_dev = dryrun.MESHES[mesh_kind].size
    assert rec["n_devices"] == n_dev == (512 if mesh_kind == "2x16x16"
                                         else 256)
    assert rec["per_device"] == "trace"
    assert rec["n_micro"] == (4 if mesh_kind == "2x16x16" else 8)
    assert rec["collective_wire_bytes"] > 0
    assert {"all-gather", "reduce-scatter"} <= set(rec["collectives"])
    assert "collective_reason" not in rec
    assert rec["flops_total"] == pytest.approx(rec["flops_per_device"]
                                               * n_dev)
    assert roofline.roofline_row(rec)["collective_s"] == pytest.approx(
        rec["collective_wire_bytes"] / roofline.NVLINK_BW)
    C, E, D = _capacity(4096, cfg.moe), cfg.moe.n_experts, cfg.d_model
    buffers = [
        sig for sig, _ in records_of(log) if cost(sig)["collective"] and any(
            d[0] == "t" and len(d[1]) == 3 and d[1][0] in (E, E // 16)
            and d[1][1] % C == 0 and d[1][2] == D for d in sig[2])]
    assert bool(buffers) == ("ep_data" in opts), buffers[:3]


def test_options_and_device():
    cfg = get_config("gemma2-2b")
    assert dryrun._apply_cfg_opts(cfg, {"blockattn"}).attn_impl == "blocked"
    assert dryrun._apply_cfg_opts(cfg, {"remat_dots"}).remat == "dots"
    with pytest.raises(ValueError, match="unknown"):
        dryrun._apply_cfg_opts(cfg, {"nope"})
    assert dryrun._apply_cfg_opts(cfg, {"bf16cast"}).param_dtype == \
        "bfloat16"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dryrun.cell("gemma2-2b", "decode_32k", "h100", verbose=False)


def test_full_width_gemma2_train_cell():
    """gemma2-2b train_4k on one card, full width on fake tensors: the
    arguments exactly (f32 parameters, AdamW's m and v, the step, the
    global batch), 64 microbatches of 4 x 4096, two flash-attention
    entries a layer and microbatch (forward and remat), and FLOPs within
    [1.0, 1.6] of `model_flops_analytic` (the module docstring says
    why)."""
    rec, _ = dryrun.cell("gemma2-2b", "train_4k", "h100", device="cpu",
                         verbose=False)
    n = rec["n_params"]
    assert n == 3_204_165_888
    mem = rec["memory"]["argument_breakdown"]
    assert mem == {"params": 4 * n, "opt_state": 8 * n + 4,
                   "batch": 2 * 256 * 4096 * 4}
    assert rec["n_micro"] == 64 and rec["micro_batch"] == 4
    assert rec["fits"] and rec["collective_wire_bytes"] == 0
    assert rec["flash_attention_entries"] == 64 * 2 * 26
    ratio = rec["flops_per_device"] / rec["model_flops"]
    assert 1.0 <= ratio <= 1.6, ratio


@pytest.mark.cuda
def test_flash_entries_equal_launches_on_card():
    """On the card: one analyzer entry a tensor-core launch, and a cell
    traced on fake CUDA tensors by default."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(1, n, 256, 64, generator=g, device="cuda",
                           dtype=torch.bfloat16) for n in (8, 4, 4))
    before = fa.launches_sm90
    with OpAnalyzer() as an:
        fa.attention(q, k, v, causal=True, softcap=50.0)
    torch.cuda.synchronize()
    assert an.summary()["flash_attention_entries"] == 1 == \
        fa.launches_sm90 - before
    rec, _ = dryrun.cell("gemma2-2b", "decode_32k", "h100", verbose=False)
    assert rec["device"] == "cuda" and not rec["fits"]
