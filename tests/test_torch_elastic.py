"""The port's elastic re-sharding (`repro_torch.runtime.elastic`) and
meshes (`repro_torch.launch.mesh`) on the CPU: `shrink_mesh` grids
against the reference's (run in a subprocess with 8 host devices, as
tests/test_elastic_e2e.py runs it, so the flag cannot leak), a state
placed on a one-rank gloo mesh, and one spawned 4-rank gloo group
(`FileStore` in tmp_path, no TCP port) that shrinks a (2, 2) plan of
reduced chatglm3-6b to (1, 2) and re-shards it bit for bit."""
import json
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model as model_lib
from repro_torch.models.param import param_axes
from repro_torch.runtime import elastic
from repro_torch.ckpt.checkpoint import tree_leaves_with_paths
from repro_torch.sharding import make_plan, placements

REF_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json, sys
    sys.path.insert(0, "src")
    import jax
    from repro.runtime import elastic
    devs = jax.devices()
    out = {}
    def grid(m):
        return [[int(d.id) for d in row] for row in m.devices]
    out["lost2"] = grid(elastic.shrink_mesh(devs, 4, 2, lost=2))
    out["lost3"] = grid(elastic.shrink_mesh(devs, 4, 2, lost=3))
    out["failed"] = grid(elastic.shrink_mesh(devs, 4, 2, failed=[devs[2], 5]))
    out["failed_row0"] = grid(elastic.shrink_mesh(devs, 2, 4, failed=[1]))
    try:
        elastic.shrink_mesh(devs, 4, 2, failed=[11])
        out["unknown"] = None
    except ValueError as e:
        out["unknown"] = str(e)
    try:
        elastic.shrink_mesh(devs, 2, 4, failed=[0, 7])
        out["none_left"] = None
    except RuntimeError as e:
        out["none_left"] = str(e)
    print(json.dumps(out))
""")


def test_shrink_mesh_matches_reference():
    res = subprocess.run([sys.executable, "-c", REF_SCRIPT],
                         capture_output=True, text=True, timeout=300,
                         env={**__import__("os").environ,
                              "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stderr[-2000:]
    ref = json.loads(res.stdout.strip().splitlines()[-1])
    ranks = list(range(8))
    got = {
        "lost2": elastic.shrink_mesh(ranks, 4, 2, lost=2),
        "lost3": elastic.shrink_mesh(ranks, 4, 2, lost=3),
        "failed": elastic.shrink_mesh(ranks, 4, 2, failed=[2, 5]),
        "failed_row0": elastic.shrink_mesh(ranks, 2, 4, failed=[1]),
    }
    for k, g in got.items():
        assert g.ranks.tolist() == ref[k], k
        assert g.device_mesh is None and g.axis_names == ("data", "model")
        assert g.shape == tuple(np.shape(ref[k]))
    with pytest.raises(ValueError) as e:
        elastic.shrink_mesh(ranks, 4, 2, failed=[11])
    assert str(e.value) == ref["unknown"]
    with pytest.raises(RuntimeError) as e:
        elastic.shrink_mesh(ranks, 2, 4, failed=[0, 7])
    assert str(e.value) == ref["none_left"]
    # a shrunk grid is a mesh to plan on
    plan = elastic.replan(get_config("chatglm3-6b"), got["failed"])
    assert plan.batch_axes == ("data",) and plan._batch_div() == 2


def test_meshes_need_their_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="256 ranks"):
        mesh_lib.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="512 ranks"):
        mesh_lib.make_production_mesh(multi_pod=True, device="cpu")


def test_card_mesh_and_reshard_one_rank():
    """card_mesh on the CPU (gloo over an in-process store): the (1, 1)
    plan's placements, a host state placed on it and placed again on a
    fresh plan, every leaf's bits equal to the original's."""
    assert not dist.is_initialized()
    try:
        mesh = mesh_lib.card_mesh(device="cpu")
        assert dist.get_backend() == "gloo"
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == (1, 1)
        with pytest.raises(RuntimeError, match="256 ranks.*has 1"):
            mesh_lib.make_production_mesh(device="cpu")
        cfg = get_config("gemma2-2b").reduced()
        params = model_lib.build(cfg).init(seed=0, device="cpu")
        axes = param_axes(cfg, params)
        plan = make_plan(cfg, mesh)
        state = elastic.reshard_state(params, None, plan, axes)
        again = elastic.reshard_state(state, plan, make_plan(cfg, mesh),
                                      axes)
        for (path, want), (_, got) in zip(tree_leaves_with_paths(params),
                                          tree_leaves_with_paths(again)):
            assert tuple(got.placements) == placements(
                plan.spec_for(want.shape, _leaf(axes, path)), mesh)
            full = got.full_tensor()
            assert full.dtype == want.dtype
            assert torch.equal(full, want), path
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


RANKS_SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
    import torch, torch.distributed as dist
    import torch.multiprocessing as mp

    def run(rank, store_path, out_path):
        from torch.distributed._functional_collectives import \\
            all_gather_tensor
        from repro_torch.configs import get_config
        from repro_torch.ckpt.checkpoint import tree_leaves_with_paths
        from repro_torch.launch.mesh import make_debug_mesh
        from repro_torch.launch.op_analyzer import OpAnalyzer
        from repro_torch.models import model as model_lib
        from repro_torch.models.param import param_axes
        from repro_torch.runtime import elastic
        from repro_torch.sharding import make_plan, spec_div
        dist.init_process_group("gloo", store=dist.FileStore(store_path, 4),
                                rank=rank, world_size=4)
        try:
            # reduced, with a vocabulary and MLP wide enough (2^16
            # elements) that the plan shards them
            cfg = dataclasses.replace(get_config("chatglm3-6b").reduced(),
                                      vocab_size=4096, d_ff=2048)
            params = model_lib.build(cfg).init(seed=0, device="cpu")
            axes = param_axes(cfg, params)
            mesh = make_debug_mesh(2, 2, device="cpu")
            plan = make_plan(cfg, mesh)
            state = elastic.reshard_state(params, None, plan, axes)
            grid = elastic.shrink_mesh(range(4), 2, 2, failed=[3],
                                       device="cpu")
            new_plan = elastic.replan(cfg, grid)
            moved = elastic.reshard_state(state, plan, new_plan, axes)
            out = {"grid": grid.ranks.tolist(), "equal": 0, "leaves": 0,
                   "sharded_old": 0, "sharded_new": 0}
            specs = plan.param_specs(params, axes)
            new_specs = new_plan.param_specs(params, axes)
            for (path, want), (_, got), (_, s0), (_, s1) in zip(
                    tree_leaves_with_paths(params),
                    tree_leaves_with_paths(moved),
                    tree_leaves_with_paths(specs),
                    tree_leaves_with_paths(new_specs)):
                out["leaves"] += 1
                out["sharded_old"] += spec_div(s0, mesh) > 1
                out["sharded_new"] += spec_div(s1, grid) > 1
                if rank in (0, 1):
                    full = got.full_tensor()
                    out["equal"] += bool(torch.equal(full, want))
            with OpAnalyzer() as an:
                all_gather_tensor(torch.ones(4, 8), 0, dist.group.WORLD)
            out["wire"] = an.summary()["wire_bytes"]
            if rank == 0:
                with open(out_path, "w") as f:
                    json.dump(out, f)
        finally:
            dist.destroy_process_group()

    if __name__ == "__main__":
        mp.spawn(run, args=(sys.argv[1], sys.argv[2]), nprocs=4, join=True)
""")


def test_four_ranks_shrink_and_reshard(tmp_path):
    script = tmp_path / "ranks.py"
    script.write_text(RANKS_SCRIPT)
    out = tmp_path / "out.json"
    env = {**__import__("os").environ, "OMP_NUM_THREADS": "1"}
    res = subprocess.run([sys.executable, str(script),
                          str(tmp_path / "store"), str(out)],
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(out.read_text())
    assert got["grid"] == [[0, 1]]
    assert got["equal"] == got["leaves"] > 0
    # the (2, 2) plan shards the 8 large leaves, and the (1, 2) plan too
    assert got["sharded_old"] == got["sharded_new"] == 8
    # an all-gather of 4 x 8 f32 from each of 4 ranks: 512 bytes x 3/4
    assert got["wire"] == 512 * 3 / 4
