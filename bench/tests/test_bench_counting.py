"""The yardstick's counts against hand counts at both cells' shapes."""
import pytest

from bench.counting import attention as A
from bench.counting import model_flops as MF
from bench.counting import peaks
from bench.lib import spec
from bench.lib.model_shape import shape_of
from conftest import config


def test_peaks():
    assert peaks.BF16_FLOPS == 989e12 and peaks.HBM_BYTES_PER_S == 3.35e12


def test_causal_pairs():
    assert A.causal_pairs(1) == 1 and A.causal_pairs(4) == 10
    assert A.causal_pairs(8192) == 33_558_528


@pytest.mark.parametrize("H,K,S", [(32, 8, 8192), (16, 16, 4096)])
def test_attention_counts(H, K, S):
    D = 128
    pairs = S * (S + 1) // 2
    assert A.forward_flops(1, H, S, D) == 4 * D * pairs * H
    assert A.backward_flops(1, H, S, D) == 10 * D * pairs * H
    assert A.forward_bytes(1, H, K, S, D) == 2 * S * D * (2 * H + 2 * K)
    assert A.backward_bytes(1, H, K, S, D) == 2 * S * D * (3 * H + 3 * K)
    # both launches are bound by their work at these shapes
    assert A.forward_bound_s(1, H, K, S, D) == pytest.approx(
        4 * D * pairs * H / 989e12)
    assert A.backward_bound_s(1, H, K, S, D) == pytest.approx(
        10 * D * pairs * H / 989e12)


def test_mistral_step_flops(bench):
    s = shape_of(spec.load_config(bench, "mistral-nemo-12b"))
    d, L = 5120, s.n_layers
    per_layer = d * 128 * (2 * 32 + 2 * 8) + 3 * d * 14336
    assert per_layer == 272_629_760
    n = L * per_layer + d * 131072
    assert MF.matmul_params_per_token(s) == n
    attn = 12 * 32 * 128 * 33_558_528 * 4 * L
    assert MF.step_flops(s, 4, 8192) == pytest.approx(6 * 32768 * n + attn)


def test_olmoe_step_flops():
    s = shape_of(config("olmoe-1b-7b"))
    d, L = 2048, s.n_layers
    per_layer = d * 128 * (2 * 16 + 2 * 16) + d * 64 + 8 * 3 * d * 1024
    assert per_layer == 67_239_936
    n = L * per_layer + d * 50304
    assert MF.matmul_params_per_token(s) == n
    attn = 12 * 16 * 128 * (4096 * 4097 // 2) * 4 * L
    assert MF.step_flops(s, 4, 4096) == pytest.approx(6 * 16384 * n + attn)


def test_olmoe_capacity():
    s = shape_of(config("olmoe-1b-7b"))
    assert s.capacity(4096) == 640
