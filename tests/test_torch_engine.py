"""Port parity of the serving engine (`repro_torch.serve.Engine`).

Reduced gemma2 with 2 kv heads (grouped-query attention), the reference's
weights carried across, and `make_batch(cfg, 2, 8, "prefill")`: 6 greedy
tokens after an 8-token prompt, so decode crosses the local layers'
window of 8. In f32 compute the tokens are equal, and the logits within
1e-4. In bf16 compute the logits agree within 2e-2 (the reference's bf16
kernel tolerance) and the tokens are equal wherever the reference's
top-2 logit margin exceeds twice that: below it, the two frameworks'
bf16 roundings may pick either token. The KV caches are bf16 in both
packages at any compute type; they agree within one bf16 step.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import model as ref_model
from repro.models.inputs import make_batch as ref_make_batch
from repro.models.param import values_of
from repro.serve.engine import Engine as RefEngine

from repro_torch.configs import get_config
from repro_torch.convert import model_params
from repro_torch.models.inputs import make_batch
from repro_torch.serve import Engine

ROOT = Path(__file__).resolve().parent.parent
N_TOKENS = 6
MAX_SEQ = 16
BF16_STEP = 2 ** -8


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    """(reference engine, port engine, reference model, cdt) on the same
    weights."""
    cdt = request.param
    kw = dict(n_kv_heads=2, compute_dtype=cdt)
    rcfg = dataclasses.replace(ref_get_config("gemma2-2b").reduced(), **kw)
    tcfg = dataclasses.replace(get_config("gemma2-2b").reduced(), **kw)
    rm = ref_model.build(rcfg)
    rparams = values_of(rm.init(jax.random.PRNGKey(0)))
    ref = RefEngine.build(rcfg, max_seq=MAX_SEQ, params=rparams)
    port = Engine.build(tcfg, max_seq=MAX_SEQ, device="cpu",
                        params=model_params(jax.tree.map(np.asarray, rparams),
                                            tcfg, device="cpu"))
    return ref, port, rm, cdt


def batches(ref, port):
    rb = ref_make_batch(ref.model.cfg, 2, 8, "prefill")
    tb = make_batch(port.model.cfg, 2, 8, "prefill", device="cpu")
    np.testing.assert_array_equal(tb["tokens"].numpy(),
                                  np.asarray(rb["tokens"]))
    return rb, tb


def assert_caches_close(got, want, pattern_len):
    """Port caches (one dict per layer) against the reference's (one dict
    per spec, leading steps axis)."""
    for layer, c in enumerate(got):
        r = want[layer % pattern_len]
        for name in ("k", "v"):
            assert c[name].dtype == torch.bfloat16
            np.testing.assert_allclose(
                c[name].float().numpy(),
                np.asarray(r[name][layer // pattern_len], np.float32),
                rtol=BF16_STEP, atol=BF16_STEP)


def margins(logits, V):
    """Top-2 gap of each row's last-position logits."""
    top = np.sort(np.asarray(logits, np.float32)[:, -1, :V], axis=-1)
    return top[:, -1] - top[:, -2]


def reference_margins(ref, rm, rb, n_tokens):
    """(n_tokens, B) top-2 margins of the reference's logits along its own
    greedy path: the choice of token i is made on row i."""
    V = ref.model.cfg.vocab_size
    logits, cache = rm.prefill(ref.params, rb, max_seq=MAX_SEQ)
    out = []
    for _ in range(n_tokens):
        out.append(margins(logits, V))
        tok = jnp.argmax(logits[:, -1:, :V], axis=-1).astype(jnp.int32)
        logits, cache = rm.decode_step(ref.params, tok, cache)
    return np.stack(out)


def test_generate_matches_reference(pair):
    """Tokens equal up to each sequence's first choice whose reference
    margin is within twice the logits' tolerance (none in f32)."""
    ref, port, rm, cdt = pair
    rb, tb = batches(ref, port)
    want = ref.generate(rb, N_TOKENS)
    calls = []
    got = port.generate(tb, N_TOKENS, progress_cb=lambda i, n:
                        calls.append((i, n)))
    assert got.shape == (2, N_TOKENS) and got.dtype == np.int32
    assert calls == [(i + 1, N_TOKENS) for i in range(N_TOKENS)]
    tol = 1e-4 if cdt == "float32" else 2e-2
    unclear = reference_margins(ref, rm, rb, N_TOKENS) <= 2 * tol
    for b in range(got.shape[0]):
        n = int(np.argmax(unclear[:, b])) if unclear[:, b].any() \
            else N_TOKENS
        if cdt == "float32":
            assert n == N_TOKENS
        np.testing.assert_array_equal(got[b, :n], want[b, :n])


def test_each_step_matches_reference(pair):
    """Prefill logits, every decode step's choice where the reference's
    margin is clear, and both caches after prefill and after the last
    step. The port is fed the reference's tokens so each step is held on
    its own."""
    ref, port, rm, cdt = pair
    rb, tb = batches(ref, port)
    cfg = port.model.cfg
    V, n_spec = cfg.vocab_size, 2
    tol = 1e-4 if cdt == "float32" else 2e-2
    rlogits, rcache = rm.prefill(ref.params, rb, max_seq=MAX_SEQ)
    logits, cache = port.model.prefill(port.params, tb, MAX_SEQ)
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits),
                               atol=tol, rtol=tol)
    np.testing.assert_array_equal(cache["lengths"].numpy(),
                                  np.asarray(rcache["lengths"]))
    assert_caches_close(cache["kv"], rcache["kv"], n_spec)
    clear = 0
    for _ in range(N_TOKENS):
        rtok = jnp.argmax(rlogits[:, -1:, :V], axis=-1).astype(jnp.int32)
        tok = torch.argmax(logits[:, -1:, :V], dim=-1).to(torch.int32)
        # a choice is clear when the logits' tolerance cannot swap the
        # top two; in f32 every choice here is
        sure = margins(rlogits, V) > 2 * tol
        clear += int(sure.sum())
        np.testing.assert_array_equal(tok.numpy()[sure],
                                      np.asarray(rtok)[sure])
        if cdt == "float32":
            assert sure.all()
        rlogits, rcache = rm.decode_step(ref.params, rtok, rcache)
        logits, cache = port.model.decode_step(
            port.params, torch.from_numpy(np.array(rtok)), cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits),
                                   atol=tol, rtol=tol)
    assert clear >= N_TOKENS  # the check compared real choices
    np.testing.assert_array_equal(cache["lengths"].numpy(),
                                  np.asarray(rcache["lengths"]))
    assert_caches_close(cache["kv"], rcache["kv"], n_spec)


def test_engine_casts_weights_once_and_checks_lengths(pair):
    _, port, _, cdt = pair
    blk = port.params["blocks"][0]
    assert blk["attn"]["wq"].dtype == getattr(torch, cdt)
    assert port.params["embed"].dtype == getattr(torch, cdt)
    assert blk["ln1"].dtype == torch.float32  # rms_norm reads it in f32
    assert port.params["final_norm"].dtype == torch.float32
    tb = make_batch(port.model.cfg, 1, 12, "prefill", device="cpu")
    with pytest.raises(ValueError, match="max_seq"):
        port.generate(tb, MAX_SEQ - 11)


def test_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device exists")
    cfg = get_config("gemma2-2b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine.build(cfg, max_seq=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_batch(cfg, 1, 8, "prefill")


def test_serving_imports_neither_jax_nor_the_reference():
    code = (
        "import sys\n"
        "import repro_torch.serve, repro_torch.models\n"
        "import repro_torch.models.inputs, repro_torch.convert\n"
        "import repro_torch.serve.loop, repro_torch.serve.scheduler\n"
        "import repro_torch.serve.requests, repro_torch.obs.tail\n"
        "import repro_torch.runtime.telemetry\n"
        "import repro_torch.launch.serve, repro_torch.configs.chronos_sim\n"
        "from repro_torch.configs import SHAPES, shape_applicable\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
