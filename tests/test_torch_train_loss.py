"""The port's losses against the JAX package's, on the CPU.

``layers.cross_entropy_loss`` (chunked and unchunked, softcapped, with -1
labels) and ``DecoderLM.loss`` / ``EncDecLM.loss`` with their gradients
against ``jax.value_and_grad(model.loss)``, on the reduced configs of
tests/test_torch_lm.py in fp32.  Tolerances: the cross-entropy alone within
``CE_TOL`` relative (fp32 sums in another order); a model's loss within
``LOSS_TOL``, the fp32 tolerance that test_torch_lm.py holds the forward
pass to; each gradient leaf within ``GRAD_TOL`` relative L2 (relative to
at least ``ZERO_FLOOR`` of the whole gradient's norm).  ``remat`` on
and off give equal gradients.  On the CPU the kernels' wrappers take their
plain versions, which autograd differentiates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build_model as jax_build
from repro.models import get_config as jax_config
from repro.models import layers as JL

from repro_torch.convert import to_torch
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import build_model, get_config
from repro_torch.models import layers as TL

from test_models_smoke import reduce_cfg as reduce_any
from test_torch_lm import jax_params, reduce_cfg

CE_TOL = 1e-5
LOSS_TOL = 1e-4
GRAD_TOL = 1e-3
# a leaf whose gradient is zero in exact arithmetic (an attention's k bias:
# the softmax does not see a shift shared by a query's scores) holds
# rounding noise in both packages (~1e-8 against a whole gradient of norm
# ~3 in whisper's); its error is taken relative to at least this fraction
# of the whole gradient's norm, so that GRAD_TOL x ZERO_FLOOR = 1e-7 is
# about one float32 ulp of it
ZERO_FLOOR = 1e-4
ARCHS = ["granite-8b", "gemma2-9b", "zamba2-2.7b", "qwen2-moe-a2.7b",
         "xlstm-125m", "internvl2-76b"]
B, S = 2, 16


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) /
                 max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("softcap", [None, 30.0])
@pytest.mark.parametrize("seq_chunk", [None, 4, 5])
def test_cross_entropy_matches_jax(seq_chunk, softcap):
    rng = np.random.default_rng(0)
    Bc, Sc, D, V = 2, 12, 16, 40
    x = rng.standard_normal((Bc, Sc, D)).astype(np.float32)
    table = rng.standard_normal((V, D)).astype(np.float32)
    labels = rng.integers(0, V, (Bc, Sc)).astype(np.int32)
    labels[0, :3] = -1                    # an ignored prefix

    def jloss(x, table):
        return JL.cross_entropy_loss({"table": table}, x, jnp.asarray(labels),
                                     softcap=softcap, seq_chunk=seq_chunk)

    jval, (jgx, jgt) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(table))
    tx = torch.from_numpy(x).requires_grad_()
    tt = torch.from_numpy(table).requires_grad_()
    tval = TL.cross_entropy_loss({"table": tt}, tx,
                                 torch.from_numpy(labels), softcap=softcap,
                                 seq_chunk=seq_chunk)
    gx, gt = torch.autograd.grad(tval, (tx, tt))
    assert abs(tval.item() - float(jval)) <= CE_TOL * abs(float(jval))
    assert _rel_l2(gx, jgx) <= CE_TOL and _rel_l2(gt, jgt) <= CE_TOL
    whole = TL.cross_entropy_loss({"table": tt}, tx,
                                  torch.from_numpy(labels), softcap=softcap)
    assert abs(tval.item() - whole.item()) <= CE_TOL * abs(whole.item())


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S), dtype=np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)}
    if cfg.n_img_tokens:
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    return batch


def _hold_against_jax(jcfg, tcfg):
    jmodel, tmodel = jax_build(jcfg), build_model(tcfg, device="cpu")
    np_params = jax_params(jmodel, "float32")
    batch = _batch(jcfg)
    (jloss, jmetrics), jgrads = jax.value_and_grad(
        jmodel.loss, has_aux=True)(jax.tree.map(jnp.asarray, np_params),
                                   jax.tree.map(jnp.asarray, batch))
    tloss, tmetrics, tgrads = value_and_grad(
        tmodel.loss, to_torch(np_params, "cpu"), to_torch(batch, "cpu"))
    assert abs(tloss.item() - float(jloss)) <= LOSS_TOL * abs(float(jloss))
    for key in ("nll", "aux"):
        np.testing.assert_allclose(tmetrics[key].item(), float(jmetrics[key]),
                                   rtol=LOSS_TOL, atol=LOSS_TOL)
    jleaves, tleaves = jax.tree.leaves(jgrads), TL.tree_leaves(tgrads)
    assert [tuple(t.shape) for t in tleaves] == \
        [tuple(a.shape) for a in jleaves]
    floor = ZERO_FLOOR * np.sqrt(sum(np.sum(np.square(a, dtype=np.float64))
                                     for a in jleaves))
    errs = [np.linalg.norm(t.double().numpy() - np.asarray(a, np.float64))
            / max(np.linalg.norm(np.asarray(a, np.float64)), floor)
            for t, a in zip(tleaves, jleaves)]
    assert max(errs) <= GRAD_TOL, errs


@pytest.mark.parametrize("arch", ARCHS)
def test_decoder_loss_and_grads_match_jax(arch):
    _hold_against_jax(reduce_cfg(jax_config(arch)),
                      reduce_cfg(get_config(arch)))


def test_encdec_loss_and_grads_match_jax():
    # the JAX encoder's scan cannot carry fp32 parameters past its bf16
    # input (test_torch_encdec.py): run it unrolled
    _hold_against_jax(reduce_any(jax_config("whisper-medium")).replace(
        scan_layers=False), reduce_any(get_config("whisper-medium")))


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "whisper-medium"])
def test_remat_gives_equal_gradients(arch):
    reduce = reduce_any if arch == "whisper-medium" else reduce_cfg
    cfg = reduce(get_config(arch))
    params = build_model(cfg, device="cpu").init(seed=0, dtype=torch.float32)
    batch = to_torch(_batch(cfg), "cpu")
    out = [value_and_grad(build_model(cfg.replace(remat=remat),
                                      device="cpu").loss, params, batch)
           for remat in (False, True)]
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(TL.tree_leaves(out[0][2]), TL.tree_leaves(out[1][2])):
        assert torch.equal(a, b)
