"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's, on the CPU, in fp32 at tests/test_moe.py's tolerance (1e-4
relative, 1e-5 absolute).

Parameters are the JAX package's ``init_tree`` draws with seeded numpy
noise on the zero-initialised shared gate, carried by ``convert.to_torch``;
inputs are seeded numpy normals.  Covered: both dispatches (sort, the
default, and the one-hot oracle), overflow dropping at a small capacity
factor, padded experts (10 real of 12) never routed, the shared expert
behind its sigmoid gate, the Switch aux loss, and the MoE configs' active
parameter and FLOP counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JShape
from repro.launch import steps as jsteps
from repro.models import get_config as jax_config
from repro.models import layers as JL
from repro.models import moe as jmoe

from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import to_torch
from repro_torch.launch import steps
from repro_torch.models import get_config
from repro_torch.models import moe as tmoe

TOL = dict(rtol=1e-4, atol=1e-5)            # tests/test_moe.py:33


def _params(n_experts=12, d=32, d_ff=16, shared=0, seed=0):
    spec = jmoe.moe_spec(d, d_ff, n_experts, n_shared=1 if shared else 0,
                         d_shared=shared, pad_to=4)
    params = jax.tree.map(np.asarray, JL.init_tree(
        spec, jax.random.PRNGKey(seed), jnp.float32))
    if shared:      # the gate starts at zero: give it a part to play
        rng = np.random.default_rng(seed)
        params["shared_gate"] = rng.standard_normal(
            params["shared_gate"].shape).astype(np.float32)
    return params


def _run(params, x, **kw):
    jy, ja = jmoe.moe(jax.tree.map(jnp.asarray, params), jnp.asarray(x), **kw)
    ty, ta = tmoe.moe(to_torch(params, "cpu"), torch.from_numpy(x), **kw)
    return (ty.numpy(), float(ta)), (np.asarray(jy), float(ja))


@pytest.mark.parametrize("impl", ["sort", "onehot"])
@pytest.mark.parametrize("case", [
    # shape, group, top_k, n_experts, capacity factor, shared width
    ((2, 16), 16, 2, 12, 1.25, 0),
    ((4, 32), 64, 4, 12, 1.25, 0),
    ((2, 32), 64, 4, 12, 0.25, 0),          # overflow: slots dropped
    ((2, 16), 16, 2, 10, 1.25, 0),          # 10 real experts of 12
    ((2, 16), 16, 2, 12, 1.25, 24),         # shared expert, sigmoid gate
    ((1, 8), 512, 1, 12, 1.25, 24),         # one group of 8 tokens
])
def test_moe_matches_jax(impl, case):
    (B, S), group, top_k, n_experts, factor, shared = case
    params = _params(shared=shared, seed=top_k)
    x = np.random.default_rng(1).standard_normal((B, S, 32)).astype(
        np.float32)
    (ty, ta), (jy, ja) = _run(params, x, top_k=top_k, n_experts=n_experts,
                              capacity_factor=factor, activation="silu",
                              group_size=group, impl=impl)
    np.testing.assert_allclose(ty, jy, **TOL)
    np.testing.assert_allclose(ta, ja, rtol=1e-5)


def test_sort_matches_onehot_and_drops_overflow():
    """The port's two dispatches agree with each other, and a capacity
    factor small enough to drop slots changes the output."""
    params = to_torch(_params(seed=5), "cpu")
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 32, 32)).astype(np.float32))
    kw = dict(top_k=4, n_experts=12, group_size=64)
    outs = {(impl, f): tmoe.moe(params, x, impl=impl, capacity_factor=f,
                                **kw)[0]
            for impl in ("sort", "onehot") for f in (0.25, 4.0)}
    for f in (0.25, 4.0):
        np.testing.assert_allclose(outs["sort", f].numpy(),
                                   outs["onehot", f].numpy(), **TOL)
    assert not torch.allclose(outs["sort", 0.25], outs["sort", 4.0])


def test_padded_experts_are_never_routed():
    """With 10 real experts of 12, no token's top-k holds expert 10 or 11,
    and zeroing their weights changes nothing."""
    params = to_torch(_params(seed=7), "cpu")
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 16, 32)).astype(np.float32))
    _, _, idx = tmoe._route(params, x.reshape(2, 16, 32), top_k=2,
                            n_experts=10)
    assert int(idx.max()) < 10
    y, _ = tmoe.moe(params, x, top_k=2, n_experts=10, group_size=16)
    for k in ("w_gate", "w_up", "w_down"):
        params[k][10:] = 0.0
    y0, _ = tmoe.moe(params, x, top_k=2, n_experts=10, group_size=16)
    assert torch.equal(y, y0)


def test_capacity_and_padding_match_jax():
    for g, E, k, f in ((512, 64, 4, 1.25), (8, 64, 1, 1.0), (64, 12, 4, 0.25),
                       (2048, 48, 8, 1.25)):
        assert tmoe._capacity(g, E, k, f) == jmoe._capacity(g, E, k, f)
    for n in (60, 40, 16, 1):
        assert tmoe.pad_experts(n) == jmoe.pad_experts(n)
    with pytest.raises(ValueError, match="multiple of the group"):
        tmoe.moe(to_torch(_params(), "cpu"), torch.zeros((1, 24, 32)),
                 top_k=2, n_experts=12, group_size=16)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "granite-moe-3b-a800m"])
def test_active_params_and_flops_match_jax(arch):
    jcfg, tcfg = jax_config(arch), get_config(arch)
    assert steps.count_params(tcfg) == jsteps.count_params(jcfg)
    assert steps.count_active_params(tcfg) == \
        jsteps.count_active_params(jcfg)
    for kind, batch, seq in (("train", 8, 4096), ("prefill", 4, 2048),
                             ("decode", 16, 4096)):
        jshape = JShape(name=kind, kind=kind, seq_len=seq, global_batch=batch)
        tshape = ShapeConfig(name=kind, kind=kind, seq_len=seq,
                             global_batch=batch)
        assert steps.model_flops(tcfg, tshape) == \
            jsteps.model_flops(jcfg, jshape)
