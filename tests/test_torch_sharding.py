"""The port's sharding planner (`repro_torch.sharding.planner`) and
parameter axes (`repro_torch.models.param.param_axes`) against the JAX
package's, leaf by leaf, on both production meshes with no devices.

The reference stacks layers into one leaf with leading "layers" axes
(zamba2's groups carry two); the port keeps one leaf a layer. So a port
leaf is held against the reference leaf that holds it, with the
reference's leading "layers" entries dropped; they must be None (and a
replicated reference spec, empty, must be empty in the port)."""
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from repro.configs import ALL_ARCHS, get_config as ref_config
from repro.models import model as ref_model
from repro.models.param import is_meta
from repro.sharding.planner import make_plan as ref_make_plan
from repro.train.optimizer import make_optimizer as ref_make_optimizer
from repro_torch.ckpt.checkpoint import tree_leaves_with_paths
from repro_torch.configs import get_config
from repro_torch.models import model as model_lib
from repro_torch.models.param import abstract_params, param_axes
from repro_torch.models.transformer import block_pattern
from repro_torch.sharding import (PlanMesh, Spec, check_spec, make_plan,
                                  placements)
from repro_torch.train.optimizer import make_optimizer


class FakeMesh:
    """The reference tests' stand-in mesh (tests/test_sharding.py)."""

    def __init__(self, shape, names):
        self.devices = np.empty(shape, dtype=object)
        self.axis_names = names


MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def ref_mesh(kind):
    return FakeMesh(*MESHES[kind])


def port_mesh(kind):
    return PlanMesh(*MESHES[kind])


def _key(k):
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return getattr(k, attr)
    raise TypeError(k)


def flat(tree, is_leaf):
    """{path tuple: leaf} of a jax tree."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {tuple(_key(k) for k in path): leaf for path, leaf in leaves}


def is_spec(x):
    return isinstance(x, PartitionSpec)


def norm(spec):
    """Entries with 1-tuples as plain names."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def ref_path(path, cfg):
    """(the reference leaf's path, its leading "layers" entries) of a
    port leaf's path."""
    top = path[0]
    if top == "blocks":
        if cfg.family == "ssm":
            return ("blocks",) + path[2:], 1
        return ("blocks", path[1] % len(block_pattern(cfg).specs)) + \
            path[2:], 1
    if top == "groups":
        return ("groups",) + path[3:], 2
    if top == "tail":
        return ("tail",) + path[2:], 1
    return path, 0


def held(port_tree, ref_flat, cfg):
    """[(path, port spec, reference spec less its layers entries)]."""
    out = []
    for path, spec in tree_leaves_with_paths(port_tree):
        rp, drop = ref_path(path, cfg)
        ref = norm(ref_flat[rp])
        if ref:
            assert all(e is None for e in ref[:drop]), (path, ref)
            ref = ref[drop:]
        out.append((path, norm(spec), ref))
    return out


_REF_META = {}


def ref_meta(name):
    if name not in _REF_META:
        cfg = ref_config(name)
        _REF_META[name] = jax.eval_shape(ref_model.build(cfg).init,
                                         jax.random.PRNGKey(0))
    return _REF_META[name]


@pytest.mark.parametrize("name", ALL_ARCHS)
def test_param_axes_match_reference(name):
    cfg = get_config(name)
    params = abstract_params(cfg)
    axes = param_axes(cfg, params)
    ref = flat(ref_meta(name), is_meta)
    n = 0
    for (path, leaf), (_, p) in zip(tree_leaves_with_paths(axes),
                                    tree_leaves_with_paths(params)):
        rp, drop = ref_path(path, cfg)
        m = ref[rp]
        assert m.axes[:drop] == ("layers",) * drop, (path, m.axes)
        assert leaf.axes == m.axes[drop:], (path, leaf.axes, m.axes)
        assert leaf.depth == math.prod(m.value.shape[:drop]), path
        assert tuple(p.shape) == tuple(m.value.shape[drop:]), path
        n += 1
    assert n == len(tree_leaves_with_paths(params))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", ALL_ARCHS)
def test_param_specs_match_reference(name, mesh):
    cfg = get_config(name)
    params = abstract_params(cfg)
    specs = make_plan(cfg, port_mesh(mesh)).param_specs(params)
    ref = flat(ref_make_plan(ref_config(name), ref_mesh(mesh)).param_specs(
        ref_meta(name)), is_spec)
    rows = held(specs, ref, cfg)
    bad = [r for r in rows if r[1] != r[2]]
    assert not bad, bad[:5]
    # every port spec is valid on its mesh (the reference test's check)
    for (path, spec), (_, p) in zip(tree_leaves_with_paths(specs),
                                    tree_leaves_with_paths(params)):
        check_spec(spec, tuple(p.shape), port_mesh(mesh))


@pytest.mark.parametrize("name,opt,mesh", [
    ("olmoe-1b-7b", "ep_data", "16x16"),
    ("arctic-480b", "pod_fsdp", "2x16x16"),
    ("arctic-480b", "ep_data", "2x16x16")])
def test_plan_options_match_reference(name, opt, mesh):
    cfg = get_config(name)
    params = abstract_params(cfg)
    plan = make_plan(cfg, port_mesh(mesh), opts=frozenset({opt}))
    rplan = ref_make_plan(ref_config(name), ref_mesh(mesh),
                          opts=frozenset({opt}))
    assert plan.notes == rplan.notes
    assert plan.fsdp_axes == rplan.fsdp_axes
    rows = held(plan.param_specs(params),
                flat(rplan.param_specs(ref_meta(name)), is_spec), cfg)
    assert [r for r in rows if r[1] != r[2]] == []
    # the option changes something
    base = make_plan(cfg, port_mesh(mesh)).param_specs(params)
    assert any(norm(a) != norm(b) for (_, a), (_, b) in zip(
        tree_leaves_with_paths(base),
        tree_leaves_with_paths(plan.param_specs(params))))


LOGICAL = [("batch", "seq", "d_model"), ("batch", "seq", "heads", None),
           ("batch", "seq", "ffn"), ("batch", "seq", "kv_heads", None),
           ("batch", "seq", "vocab"), ("experts", "batch", "ffn"),
           ("batch", "seq", "ssm_heads", None), ("batch", "seq", "ssm_in"),
           ("seq", "heads"), ("batch", "experts", None, "d_model")]


@pytest.mark.parametrize("name", ["gemma2-2b", "chatglm3-6b", "olmoe-1b-7b",
                                  "mamba2-2.7b"])
def test_act_spec_matches_reference(name):
    """Right to left: under context-parallel attention (gemma2's 8 heads
    do not divide 16) seq -> model, yet ("batch", "seq", "ffn") keeps
    ffn on model and gathers seq."""
    for mesh in MESHES:
        plan = make_plan(get_config(name), port_mesh(mesh))
        rplan = ref_make_plan(ref_config(name), ref_mesh(mesh))
        assert plan.context_parallel_attn == rplan.context_parallel_attn
        for logical in LOGICAL:
            assert norm(plan.act_spec(logical)) == \
                norm(rplan.act_spec(logical)), (mesh, logical)
    plan = make_plan(get_config("gemma2-2b"), port_mesh("16x16"))
    assert plan.act_spec(("batch", "seq", "ffn")) == \
        (("data",), None, "model")
    assert plan.act_spec(("batch", "seq", "d_model"))[1] == "model"


@pytest.mark.parametrize("batch", [256, 32, 16, 8, 1])
def test_batch_spec_matches_reference(batch):
    from repro.models.inputs import batch_struct as ref_batch_struct
    from repro_torch.models.inputs import batch_struct
    for name in ("gemma2-2b", "paligemma-3b", "hubert-xlarge"):
        for mesh in MESHES:
            plan = make_plan(get_config(name), port_mesh(mesh))
            rplan = ref_make_plan(ref_config(name), ref_mesh(mesh))
            with torch._subclasses.fake_tensor.FakeTensorMode():
                b = batch_struct(get_config(name), batch, 4096, "train",
                                 device="cpu")
            got = {k: norm(v) for k, v in plan.batch_spec(b).items()}
            want = {k: norm(v) for k, v in rplan.batch_spec(
                ref_batch_struct(ref_config(name), batch, 4096,
                                 "train")).items()}
            assert got == want, (name, mesh, batch)
            assert plan._batch_div() == rplan._batch_div()


def ref_cache_path(path, cfg):
    """The reference's cache leaf (and leading layer dims) of a port
    cache path."""
    top = path[0]
    if top == "lengths":
        return ("lengths",), 0
    if cfg.family == "ssm":                 # states[l][i]
        return ("states", path[2]), 1
    if cfg.family == "hybrid":
        if top == "groups":                 # groups[g][i][j]
            return ("groups", path[3]), 2
        if top == "tail":                   # tail[l][j]
            return ("tail", path[2]), 1
        return ("attn_" + path[2],), 1      # kv[g]["k" / "v"]
    n = len(block_pattern(cfg).specs)       # kv[l]["k" / "v"]
    return ("kv", path[1] % n, path[2]), 1


@pytest.mark.parametrize("batch", [128, 1])
@pytest.mark.parametrize("name", ["gemma2-2b", "mamba2-2.7b", "zamba2-7b"])
def test_cache_spec_tree_matches_reference(name, batch):
    cfg = get_config(name)
    seq = 32768
    with torch._subclasses.fake_tensor.FakeTensorMode():
        cache = model_lib.build(cfg).init_cache(batch, seq, device="cpu")
    rcache = ref_model.build(ref_config(name)).cache_spec(batch, seq)
    for mesh in MESHES:
        specs = make_plan(cfg, port_mesh(mesh)).cache_spec_tree(cache, batch)
        ref = flat(ref_make_plan(ref_config(name),
                                 ref_mesh(mesh)).cache_spec_tree(
            rcache, batch), is_spec)
        shapes = dict(tree_leaves_with_paths(cache))
        for path, spec in tree_leaves_with_paths(specs):
            rp, drop = ref_cache_path(path, cfg)
            want = norm(ref[rp])
            if want:
                assert all(e is None for e in want[:drop]), (path, want)
                want = want[drop:]
            assert norm(spec) == want, (mesh, path, spec, want)
            check_spec(spec, tuple(shapes[path].shape), port_mesh(mesh))


@pytest.mark.parametrize("name", ["gemma2-2b", "arctic-480b"])
def test_state_spec_trees_match_reference(name):
    """AdamW (gemma2-2b) and Adafactor (arctic-480b): each state leaf's
    spec is the reference's, less its layers entries."""
    cfg = get_config(name)
    params = abstract_params(cfg)
    opt, ropt = make_optimizer(cfg), ref_make_optimizer(ref_config(name))
    assert type(opt).__name__ == type(ropt).__name__
    meta = ref_meta(name)
    from repro.models.param import values_of
    for mesh in MESHES:
        pspecs = make_plan(cfg, port_mesh(mesh)).param_specs(params)
        rspecs = ref_make_plan(ref_config(name),
                               ref_mesh(mesh)).param_specs(meta)
        if cfg.optimizer == "adafactor":
            st = opt.state_spec_tree(pspecs, params)
            rst = ropt.state_spec_tree(rspecs, values_of(meta))
        else:
            st = opt.state_spec_tree(pspecs)
            rst = ropt.state_spec_tree(rspecs)
        assert st.step == Spec() and norm(rst.step) == ()
        for field in st._fields[1:]:
            rows = held(getattr(st, field),
                        flat(getattr(rst, field), is_spec), cfg)
            assert [r for r in rows if r[1] != r[2]] == [], (mesh, field)


def test_placements_of_specs():
    """Spec -> DTensor placements, a tuple entry over two mesh dims outer
    first; a wrong order or a repeated axis raises."""
    from torch.distributed.tensor import Replicate, Shard

    class Mesh3:
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 4, 4)

    assert placements(Spec(("pod", "data"), "model"), Mesh3) == (
        Shard(0), Shard(0), Shard(1))
    assert placements(Spec(None, "data"), Mesh3) == (
        Replicate(), Shard(1), Replicate())
    assert placements(Spec(), Mesh3) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="outer first"):
        placements(Spec(("data", "pod")), Mesh3)
    with pytest.raises(ValueError, match="twice"):
        placements(Spec("data", "data"), Mesh3)
    with pytest.raises(ValueError, match="does not divide"):
        check_spec(Spec("model"), (6,), port_mesh("16x16"))
