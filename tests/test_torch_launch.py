"""Port parity of the serving launcher (`repro_torch.launch.serve`) and
the last configs (`repro_torch.configs.chronos_sim`, `SHAPES`,
`shape_applicable`) on the CPU.

The reference's launcher raises TypeError before it serves: it passes
`rng=` to the frozen `ReplicaPool`, which has no such field. The port
builds the pool from its real fields (n_replicas 4, beta 1.4), so its
launcher is run here on its own and the reference's pool call is held
to its TypeError.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.configs import chronos_sim as ref_sim
from repro.serve import ReplicaPool as RefReplicaPool

from repro_torch import configs
from repro_torch.configs import chronos_sim
from repro_torch.launch import serve as launch_serve


def test_serve_launcher_runs_reduced_on_cpu(capsys):
    launch_serve.main(["--arch", "gemma2-2b", "--tokens", "4", "--device",
                       "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "decoded (2, 4) tokens on gemma2-2b-reduced"
    assert lines[1].startswith("hedged SLA attainment: ")
    pocd = float(lines[1].split()[3])
    assert 0.0 <= pocd <= 1.0
    assert len(lines) == 2


def test_serve_launcher_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--tokens", "1"])


def test_reference_pool_has_no_rng_field():
    """The reference launcher's pool call (src/repro/launch/serve.py:29)
    raises; the fields the port builds the pool from are the pool's."""
    with pytest.raises(TypeError, match="rng"):
        RefReplicaPool(n_replicas=4, beta=1.4, rng=np.random.default_rng(0))
    assert RefReplicaPool(n_replicas=4, beta=1.4).t_min_of(64) == \
        launch_serve.ReplicaPool(n_replicas=4, beta=1.4).t_min_of(64)


def test_shapes_and_shape_applicable_equal_reference():
    assert configs.SHAPES == ref_configs.SHAPES
    assert configs.ALL_ARCHS == ref_configs.ALL_ARCHS
    cells = [(a, s) for a in ref_configs.ALL_ARCHS for s in ref_configs.SHAPES]
    assert len(cells) == 40
    for arch, shape in cells:
        assert configs.shape_applicable(arch, shape) == \
            ref_configs.shape_applicable(arch, shape), (arch, shape)
    with pytest.raises(KeyError):
        configs.shape_applicable("gemma2-2b", "train_8k")


@pytest.mark.parametrize("name", ["TestbedConfig", "TraceConfig"])
def test_chronos_sim_configs_equal_reference(name):
    got, want = getattr(chronos_sim, name)(), getattr(ref_sim, name)()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    with pytest.raises(dataclasses.FrozenInstanceError):
        got.n_jobs = 1
    assert configs.chronos_sim is chronos_sim
