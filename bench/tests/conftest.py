"""The benchmark's own tests: `python -m pytest bench/tests -q` from the
root of the repository. Tests that need a card are marked `cuda` and
skip inside the test without one."""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips (inside the test) without one")


def config(name: str) -> dict:
    """`configs/<name>.json`, whether or not a cell of BENCHMARK.json
    runs it."""
    return json.loads((ROOT / "bench" / "configs" / f"{name}.json").read_text())


def tiny(name: str) -> dict:
    """The config file `name` cut to a size a CPU test holds: the port's
    own config with the same cut (`program_overrides`)."""
    cfg = config(name)
    sizes = dict(hidden_size=64, num_attention_heads=4, head_dim=16,
                 num_hidden_layers=2, vocab_size=256)
    over = dict(d_model=64, n_heads=4, head_dim=16, vocab_size=256)
    if cfg.get("num_experts"):
        sizes.update(num_key_value_heads=4, intermediate_size=32,
                     num_experts=8, num_experts_per_tok=2)
        over.update(n_kv_heads=4, d_ff=32,
                    moe=dict(n_experts=8, top_k=2, d_ff=32))
    else:
        sizes.update(num_key_value_heads=2, intermediate_size=128)
        over.update(n_kv_heads=2, d_ff=128)
    cfg.update(sizes)
    cfg["program_overrides"] = over
    return cfg


def tiny_traffic(cell: str) -> dict:
    t = json.loads((ROOT / "bench" / "workloads" / f"{cell}.json").read_text())
    t = dict(t, global_batch=4, seq_len=32, n_micro=2, n_data_shards=4,
             lr=1e-3)
    return t


@pytest.fixture
def bench():
    from bench.lib import spec
    return spec.load_benchmark()
