"""The port's encoder-decoder (``repro_torch.models.encdec``) and modality
stubs (``repro_torch.models.vision``) against the JAX package's, on the CPU.

whisper-medium reduced as tests/test_models_smoke.py reduces it (2 + 2
layers, d_model 64, 4 heads of 16, 16 frames, vocab 256), the JAX
package's parameter draws plus seeded numpy noise on the constant leaves,
carried by ``convert.to_torch``; frames and tokens are seeded numpy draws.
The JAX model runs its layers unrolled (``scan_layers=False``, the
reference's costing variant, the same arithmetic): its scanned encoder
takes bf16 parameters only, since in fp32 the bf16 frames would change the
scan carry's dtype after the first layer.  It also runs eagerly, not under
``jax.jit``: jitted, XLA's excess-precision rewrite drops the fp32 -> bf16
-> fp32 round trip of the self-attention cache within the prefill, which
moves the reduced model's prefill logits by 4.4e-3 from its own eager run
(the port agrees with the eager run to 1e-6).  In fp32: ``encode`` and the
teacher-forced pass at 1e-4 absolute plus relative (test_torch_lm.py's
fp32 tolerance); ``prefill``, its caches and three ragged ``decode_step`` s
at 1e-3, as test_torch_lm.py holds everything past a bf16 cache (both
packages keep the self and cross K/V caches in bf16).  The bf16 cache
entries themselves are held to one bf16 ulp (2^-7 relative): a value the
two compute an fp32 ulp apart may round to neighbouring bf16 values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build_model as jax_build
from repro.models import get_config as jax_config
from repro.models import layers as JL
from repro.models import vision as jvision
from repro.models.encdec import sinusoidal as jax_sinusoidal

from repro_torch.convert import to_torch
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import EncDecLM, build_model, get_config
from repro_torch.models import layers as TL
from repro_torch.models import vision
from repro_torch.models.encdec import sinusoidal

from test_models_smoke import reduce_cfg
from test_torch_lm import jax_params

TOL = dict(rtol=1e-4, atol=1e-4)
CACHE_TOL = dict(rtol=1e-3, atol=1e-3)
BF16_ULP = dict(rtol=2 ** -7, atol=1e-6)
B, S, MAX_LEN = 2, 8, 24


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.fixture(scope="module")
def whisper():
    jcfg = reduce_cfg(jax_config("whisper-medium")).replace(
        scan_layers=False)
    jmodel = jax_build(jcfg)
    np_params = jax_params(jmodel, "float32")
    tmodel = build_model(reduce_cfg(get_config("whisper-medium")),
                         device="cpu")
    rng = np.random.default_rng(1)
    frames = rng.standard_normal((B, jcfg.encoder_len, jcfg.d_model)) \
        .astype(np.float32)
    tokens = rng.integers(0, jcfg.vocab, (B, S), dtype=np.int32)
    return (jcfg, jmodel, jax.tree.map(jnp.asarray, np_params), tmodel,
            to_torch(np_params, "cpu"), frames, tokens)


def test_sinusoidal_matches_jax():
    for S_, D, off in ((16, 64, 0), (5, 32, 7), (3, 64, np.array([0, 4, 9]))):
        want = np.asarray(jax_sinusoidal(S_, D, offset=off))
        got = sinusoidal(S_, D, offset=torch.as_tensor(off))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_encode_and_teacher_forced_pass_match_jax(whisper):
    cfg, jmodel, jp, tmodel, tp, frames, tokens = whisper
    assert isinstance(tmodel, EncDecLM)
    jmem = jmodel.encode(jp, jnp.asarray(frames))
    tmem = tmodel.encode(tp, torch.from_numpy(frames))
    _close(tmem, jmem)
    # the reference's loss up to its cross-entropy
    x = jmodel._embed_tokens(jp, jnp.asarray(tokens), 0)
    x, _ = jmodel._decoder_stack(jp, x, jmem, None,
                                 positions=jnp.arange(S)[None, :],
                                 cache_len=None, mode="train")
    jh = JL.layernorm(jp["final_norm"], x)
    th, aux = tmodel.forward(tp, torch.from_numpy(tokens),
                             torch.from_numpy(frames))
    _close(th, jh)
    assert aux == 0.0


def test_prefill_caches_and_ragged_decode_match_jax(whisper):
    cfg, jmodel, jp, tmodel, tp, frames, tokens = whisper
    jcache = jmodel.init_cache(batch=B, max_len=MAX_LEN)
    jlog, jcache = jmodel.prefill(jp, jnp.asarray(tokens), jcache,
                                  frames=jnp.asarray(frames))
    tcache = tmodel.init_cache(batch=B, max_len=MAX_LEN)
    prefill = make_prefill_step(tmodel)
    tlog, tcache = prefill(tp, tcache, {"tokens": torch.from_numpy(tokens),
                                        "frames": torch.from_numpy(frames)})
    _close(tlog, jlog, CACHE_TOL)
    want = jax.tree.leaves(jcache)
    got = TL.tree_leaves(tcache)
    assert [tuple(t.shape) for t in got] == [tuple(a.shape) for a in want]
    assert all(t.dtype == torch.bfloat16 for t in got)
    for g, w in zip(got, want):
        _close(g, w, BF16_ULP)
    clen = np.array([S, S - 3], np.int32)            # row 1 drops 3 entries
    rng = np.random.default_rng(2)
    jstep = jmodel.decode_step
    tstep = make_decode_step(tmodel)
    for _ in range(3):
        tok = rng.integers(0, cfg.vocab, (B, 1), dtype=np.int32)
        jlog, jcache = jstep(jp, jnp.asarray(tok), jcache, jnp.asarray(clen))
        nxt, tlog, tcache = tstep(tp, tcache, torch.from_numpy(tok),
                                  torch.from_numpy(clen))
        _close(tlog, jlog, CACHE_TOL)
        assert torch.equal(nxt[:, 0], tlog[:, -1].argmax(dim=-1).int())
        clen = clen + 1


def test_encdec_params_keep_the_reference_tree(whisper):
    cfg, jmodel, _, tmodel, _, _, _ = whisper
    jshapes = jax.tree.map(lambda s: tuple(s.shape), jmodel.abstract_params())
    assert TL.tree_map(lambda s: s.shape, tmodel.abstract_params()) == \
        jshapes


def test_modality_stubs_match_the_reference_specs():
    for port_fn, jax_fn in ((vision.patch_embed_spec,
                             jvision.patch_embed_spec),
                            (vision.frame_embed_spec,
                             jvision.frame_embed_spec)):
        got, want = port_fn(2, 16, 64), jax_fn(2, 16, 64)
        assert got.shape == tuple(want.shape)
        assert str(got.dtype) == "torch.bfloat16" == f"torch.{want.dtype}"
    spec = vision.frame_embed_spec(2, 1500, 64)
    a = vision.synthetic_embeds(3, spec, device="cpu")
    assert a.shape == spec.shape and a.dtype == torch.bfloat16
    assert torch.equal(a, vision.synthetic_embeds(3, spec, device="cpu"))
    assert not torch.equal(a, vision.synthetic_embeds(4, spec, device="cpu"))
    assert abs(a.float().std().item() - 0.02) < 1e-3


def test_prefill_step_passes_patch_embeds():
    """A VLM backbone's prefill through ``make_prefill_step`` with
    synthetic patch embeddings equals ``prefill`` called directly, and the
    patches move the logits."""
    from test_torch_lm import reduce_cfg as lm_reduce
    cfg = lm_reduce(get_config("internvl2-76b"))
    model = build_model(cfg, device="cpu")
    params = model.init(seed=0, dtype=torch.float32)
    tokens = torch.arange(B * S, dtype=torch.int32).reshape(B, S) % cfg.vocab
    patches = vision.synthetic_embeds(
        0, vision.patch_embed_spec(B, cfg.n_img_tokens, cfg.d_model),
        device="cpu")
    step = make_prefill_step(model)
    got, _ = step(params, model.init_cache(B, 32),
                  {"tokens": tokens, "patch_embeds": patches})
    want, _ = model.prefill(params, tokens, model.init_cache(B, 32),
                            patch_embeds=patches)
    bare, _ = model.prefill(params, tokens, model.init_cache(B, 32))
    assert torch.equal(got, want)
    assert not torch.allclose(got, bare)
