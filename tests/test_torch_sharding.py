"""The port's sharding rules, divisible specs, axes trees and ``constrain``
against the JAX package's, and the kernels inside a mesh.

Specs are compared as tuples (``tuple(PartitionSpec)``).  The reference's
``_divisible_spec`` reads a mesh's ``axis_names`` and ``devices.shape``
only (``src/repro/runtime/sharding.py:130``), so it runs on a stand-in of
the production mesh; the port's reads ``mesh_dim_names`` and ``shape``, of
a stand-in and of the real ``DeviceMesh`` over the 512-rank fake group
(destroyed after the module, so no process group outlives it).
"""

import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs.base import ALL_SHAPES as REF_SHAPES
from repro.launch.steps import rules_for as ref_rules_for
from repro.models import build_model as ref_build_model
from repro.models import config_names as ref_config_names
from repro.models import get_config as ref_get_config
from repro.runtime import sharding as R
from repro_torch.configs.base import ALL_SHAPES
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import rules_for
from repro_torch.models import build_model, config_names, get_config
from repro_torch.runtime import sharding as S

RULE_SETS = [
    ("single", S.single_pod_rules(), R.single_pod_rules()),
    ("multi", S.multi_pod_rules(), R.multi_pod_rules()),
    ("smoke", S.smoke_rules(), R.smoke_rules()),
    ("single_act_seq_none", S.single_pod_rules().with_overrides(act_seq=None),
     R.single_pod_rules().with_overrides(act_seq=None)),
    ("multi_act_seq_none", S.multi_pod_rules().with_overrides(act_seq=None),
     R.multi_pod_rules().with_overrides(act_seq=None)),
]
LOGICAL = sorted(set(S.single_pod_rules().rules) |
                 set(S.multi_pod_rules().rules)) + [None, "not_a_rule"]
MESHES = {"16x16": ((16, 16), ("data", "model"), False),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"), True)}


@pytest.fixture(scope="module")
def fake_world():
    """The 512-rank fake group with both production meshes."""
    meshes = {name: make_production_mesh(multi_pod=mp)
              for name, (_, _, mp) in MESHES.items()}
    yield meshes
    dist.destroy_process_group()


def _ref_mesh(shape, names):
    return types.SimpleNamespace(axis_names=names, devices=np.empty(shape))


def _port_mesh(shape, names):
    return types.SimpleNamespace(mesh_dim_names=names, shape=shape)


# -- the rules ---------------------------------------------------------------
@pytest.mark.parametrize("name,port,ref", RULE_SETS,
                         ids=[r[0] for r in RULE_SETS])
def test_spec_of_every_logical_axis_matches(name, port, ref):
    assert port.rules == ref.rules
    for ax in LOGICAL:
        assert port.spec((ax,)) == tuple(ref.spec((ax,))), ax
        for bx in LOGICAL:
            assert port.spec((ax, bx, None)) == \
                tuple(ref.spec((ax, bx, None))), (ax, bx)


def test_reference_test_cases():
    """The cases of tests/test_sharding.py, on the port."""
    rules = S.single_pod_rules()
    assert rules.spec(("act_batch", None, None)) == ("data",)
    assert rules.spec(("embed", "heads", "head_dim")) == ("data", "model")
    assert rules.spec(("unsharded",)) == ()
    assert S.multi_pod_rules().spec(("act_batch", None)) == \
        (("pod", "data"),)
    assert rules.with_overrides(act_seq=None).spec(
        ("act_batch", "act_seq", None)) == ("data",)
    one = _port_mesh((1, 1), ("data", "model"))
    assert S._divisible_spec(one, ("data", "model"), (3, 5)) == \
        ("data", "model")
    assert S._divisible_spec(one, ("model", "model"), (4, 4)) == ("model",)
    four = _port_mesh((4, 2), ("data", "model"))
    assert S._divisible_spec(four, ("data", "model"), (6, 4)) == \
        (None, "model")


def test_shapes_are_the_references():
    assert [(s.name, s.seq_len, s.global_batch, s.kind) for s in ALL_SHAPES] \
        == [(s.name, s.seq_len, s.global_batch, s.kind) for s in REF_SHAPES]


@pytest.mark.parametrize("shape", REF_SHAPES, ids=lambda s: s.name)
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_divisible_specs_match_on_every_leaf(mesh_name, shape):
    """Every parameter and cache leaf of all 10 configs under the cell's
    rules (``rules_for``), on the production mesh's axes."""
    mshape, names, multi_pod = MESHES[mesh_name]
    port_mesh, ref_mesh = _port_mesh(mshape, names), _ref_mesh(mshape, names)
    port_rules = rules_for(shape, multi_pod=multi_pod)
    ref_rules = ref_rules_for(shape, multi_pod=multi_pod)
    n = 0
    for arch in config_names():
        model = build_model(get_config(arch), device="meta")
        leaves = [(p.axes, p.shape) for p in _leaves(model.spec())]
        specs = _paths(model.cache_spec(shape.global_batch, shape.seq_len))
        axes = _paths(model.cache_axes(shape.global_batch, shape.seq_len))
        assert specs.keys() == axes.keys()
        leaves += [(axes[k], specs[k].shape) for k in specs]
        for ax, shp in leaves:
            got = S._divisible_spec(port_mesh, port_rules.spec(ax), shp)
            want = R._divisible_spec(ref_mesh, ref_rules.spec(ax), shp)
            assert got == tuple(want), (arch, ax, shp)
            n += 1
    assert n > 250


def test_divisible_spec_reads_the_production_meshes(fake_world):
    for name, (mshape, names, _) in MESHES.items():
        mesh = fake_world[name]
        assert tuple(mesh.shape) == mshape
        assert tuple(mesh.mesh_dim_names) == names
        spec = ("data", "model", ("pod", "data") if "pod" in names else None)
        for shp in [(32, 48, 64), (16, 16, 16), (1, 4096, 8)]:
            assert S._divisible_spec(mesh, spec, shp) == \
                S._divisible_spec(_port_mesh(mshape, names), spec, shp)


def _leaves(tree):
    from repro_torch.models import layers as L
    return L.tree_leaves(tree)


# -- the axes trees ------------------------------------------------------------
def _ref_paths(tree, is_leaf, path=""):
    """{path: leaf} of a reference tree of dicts and tuples."""
    if is_leaf(tree):
        return {path: tree}
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _ref_paths(sub, is_leaf, f"{path}/{key}").items()}
    return {k: v for i, sub in enumerate(tree)
            for k, v in _ref_paths(sub, is_leaf, f"{path}/{i}").items()}


@pytest.mark.parametrize("arch", ref_config_names())
def test_param_and_cache_axes_match(arch):
    port = build_model(get_config(arch), device="meta")
    ref = ref_build_model(ref_get_config(arch))
    want = _ref_paths(ref.param_axes(), lambda t: isinstance(t, tuple))
    assert _paths(port.param_axes()) == want
    pairs = _ref_paths(ref.cache_spec(4, 64),
                       lambda t: isinstance(t, tuple) and len(t) == 2
                       and hasattr(t[0], "shape"))
    assert _paths(port.cache_axes(4, 64)) == \
        {k: axes for k, (_, axes) in pairs.items()}
    assert {k: tuple(t.shape) for k, t in
            _paths(port.cache_spec(4, 64)).items()} == \
        {k: tuple(sds.shape) for k, (sds, _) in pairs.items()}


def _paths(tree, path=""):
    """{path: leaf} of a tree of dicts and tuples whose leaves are specs or
    axes tuples (a tuple of tuples is a node)."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _paths(sub, f"{path}/{key}").items()}
    if isinstance(tree, tuple) and not S.is_axes(tree):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _paths(sub, f"{path}/{i}").items()}
    return {path: tree}


def test_axes_tree_keeps_tuples_whole():
    from repro_torch.models import layers as L
    spec = {"w": L.Pm((4, 8), ("embed", "ff")), "b": {"s": L.Pm((8,),
                                                               ("ff",))}}
    axes = L.axes_tree(spec)
    assert axes == {"w": ("embed", "ff"), "b": {"s": ("ff",)}}
    assert S.map_axes(lambda a: len(a), axes) == {"w": 2, "b": {"s": 1}}


# -- placements and constrain --------------------------------------------------
def _mesh_2x4(fake_world):
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh("cpu", torch.arange(8).reshape(2, 4),
                      mesh_dim_names=("data", "model"))


def test_placements_of_specs(fake_world):
    from torch.distributed.tensor import Replicate, Shard
    mesh = fake_world["2x16x16"]
    assert S.placements(mesh, ()) == (Replicate(),) * 3
    assert S.placements(mesh, (("pod", "data"), None, "model")) == \
        (Shard(0), Shard(0), Shard(2))
    assert S.placements(mesh, (("pod", "data", "model"),)) == (Shard(0),) * 3
    with pytest.raises(ValueError, match="order"):
        S.placements(mesh, (("model", "data"),))
    with pytest.raises(ValueError, match="no axis"):
        S.placements(_mesh_2x4(fake_world), (("pod", "data"),))


def test_tree_shardings_give_each_leafs_placements(fake_world):
    """``tree_shardings`` over a model's axes tree: each leaf's placements
    of its spec (the reference's ``NamedSharding`` of the bare spec)."""
    mesh = fake_world["16x16"]
    rules = S.single_pod_rules()
    axes = build_model(get_config("zamba2-2.7b"), device="meta").param_axes()
    got = S.tree_shardings(mesh, rules, axes)
    same = _paths(S.map_axes(
        lambda a, pl: pl == S.placements(mesh, rules.spec(a)), axes, got))
    assert all(same.values()) and len(same) > 20
    assert S.named_sharding(mesh, rules, ("act_batch", None)) == \
        S.placements(mesh, ("data",))


def test_constrain_is_the_identity_without_rules(fake_world):
    x = torch.ones(4, 8)
    assert S.constrain(x, "act_batch", None) is x
    with S.use_rules(S.single_pod_rules()):        # rules, no mesh
        assert S.constrain(x, "act_batch", None) is x
    assert S.active_rules() is None


def test_constrain_gives_the_divisible_specs_placements(fake_world):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = _mesh_2x4(fake_world)
    rules = S.single_pod_rules()
    x = DTensor.from_local(torch.empty(8, 6, 64, device="meta"), mesh,
                           [Replicate(), Replicate()], run_check=False)
    with S.use_rules(rules, mesh):
        for axes in [("act_batch", "act_seq", None),
                     ("act_batch", None, "act_ff"),
                     ("act_batch", "act_heads", "act_ff"),
                     ("act_kv_seq_full", None, None), (None, None, None)]:
            y = S.constrain(x, *axes)
            want = S.placements(mesh, S._divisible_spec(
                mesh, rules.spec(axes), (8, 6, 64)))
            assert tuple(y.placements) == want, axes
            assert y.shape == x.shape
        assert S.constrain(x, "act_batch", "act_seq", None).placements == \
            (Shard(0), Replicate())            # 6 rows do not split by 4
        with pytest.raises(TypeError, match="DTensor"):
            S.constrain(torch.empty(8, 6, device="meta"), "act_batch", None)
    assert S.active_rules() is None


# -- the kernels inside a mesh (their plain versions, on meta) -----------------
def test_kernels_run_per_shard_on_meta_dtensors(fake_world):
    """flash, SSD and decode on ``meta`` DTensors split by batch and heads:
    each returns the global shape split as its query (x); GQA kv heads that
    do not split as the query heads are repeated; a cache split on its
    sequence runs per slice and is combined across the splitting mesh
    dimension, the output split as q's batch."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    mesh = _mesh_2x4(fake_world)

    def dt(shape, pl, dtype=torch.bfloat16):
        return DTensor.from_local(torch.empty(
            [s // np.prod([mesh.size(m) for m, p in enumerate(pl)
                           if p == Shard(i)] or [1])
             for i, s in enumerate(shape)], dtype=dtype, device="meta"),
            mesh, pl, run_check=False)

    heads = [Shard(0), Shard(2)]
    q = dt((4, 64, 8, 32), heads)
    kv = dt((4, 64, 2, 32), [Shard(0), Replicate()])
    o = fa.flash_attention(q, kv, kv)
    assert o.shape == q.shape and tuple(o.placements) == tuple(heads)
    x = dt((4, 64, 8, 16), heads)
    la = dt((4, 64, 8), heads, torch.float32)
    b = dt((4, 64, 1, 16), [Shard(0), Replicate()]).expand(4, 64, 8, 16)
    y, st = ssd.ssd_scan(x, la, b, b, chunk=16)
    assert y.shape == x.shape and tuple(y.placements) == tuple(heads)
    assert st.shape == (4, 8, 16, 16) and \
        tuple(st.placements) == (Shard(0), Shard(1))
    q1 = dt((4, 8, 32), [Shard(0), Shard(1)])
    cache = dt((4, 64, 2, 32), [Shard(0), Replicate()])
    lengths = torch.full((4,), 10, dtype=torch.int32, device="meta")
    o = da.decode_attention(q1, cache, cache, lengths)
    assert o.shape == q1.shape
    seq = dt((4, 64, 2, 32), [Shard(0), Shard(1)])
    o = da.decode_attention(q1, seq, seq, lengths)
    assert o.shape == q1.shape and \
        tuple(o.placements) == (Shard(0), Replicate())
