"""The port's trainer against the JAX package's, on the CPU.

Three steps of ``launch.steps.make_train_step`` against the reference's
``make_train_step`` from one state carried across (parameters by
``convert.to_torch``, AdamW moments and step by
``convert.adamw_state_to_torch``), on reduced xlstm, dense, zamba2, MoE
(the router's aux loss and the dispatch's backward), enc-dec (frames, the
non-causal and cross attention) and VLM (patch embeddings, the -1-labelled
image prefix) configs in fp32 and the synthetic pipeline's batches (frames
and patch embeddings included): each step's loss
within ``LOSS_TOL`` relative, each parameter leaf after three steps within
``UPDATE_TOL`` of its total update (relative L2: Adam normalises near-zero
gradients, so a bound on the parameters themselves would measure noise).
Then the CLI's and the example's runs with checkpoint resume, and the
wiring of the kernels' autograd Functions with their launches stubbed by
the plain forward (on the card they launch the kernels; the tests there
are in test_torch_gpu.py).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import build_model as jax_build
from repro.models import get_config as jax_config
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import cosine_with_warmup as jcosine
from repro.optim import init_state as jinit_state

from repro_torch import convert, tracing
from repro_torch.kernels import decode_attention as da_mod
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import ssd_scan as ssd_mod
from repro_torch.kernels.ref import flash_attention_ref, ssd_ref
from repro_torch.kernels.substrate import KernelFunction
from repro_torch.launch import train as train_cli
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model, get_config
from repro_torch.models import layers as TL
from repro_torch.optim import AdamWConfig, cosine_with_warmup

from test_models_smoke import reduce_cfg as reduce_any
from test_torch_lm import jax_params, reduce_cfg

ROOT = Path(__file__).resolve().parents[1]
LOSS_TOL = 1e-4
UPDATE_TOL = 1e-3
STEPS, B, S = 3, 2, 16


def _carried_state(jp, seed=3):
    """A JAX AdamW state past its first steps: seeded moments, step 4."""
    rng = np.random.default_rng(seed)
    state = jax.tree.map(np.asarray, jinit_state(jp))

    def noise(a, scale):
        return (scale * rng.standard_normal(a.shape)).astype(np.float32)

    state["mu"] = jax.tree.map(lambda a: noise(a, 1e-3), state["mu"])
    state["nu"] = jax.tree.map(lambda a: noise(a, 1e-3) ** 2 + 1e-8,
                               state["nu"])
    state["step"] = np.asarray(4, np.int32)
    return state


def _reduced(arch):
    """(JAX config, port config), reduced; whisper's JAX encoder runs
    unrolled, as tests/test_torch_train_loss.py runs it (its scan cannot
    carry fp32 parameters past its bf16 input), and its step runs eagerly,
    as tests/test_torch_encdec.py runs the model: jitted, XLA's
    excess-precision rewrite drops the bf16 rounding of the frames plus the
    sinusoidal table, which both packages' ``encode`` writes."""
    if arch == "whisper-medium":
        return (reduce_any(jax_config(arch)).replace(scan_layers=False),
                reduce_any(get_config(arch)))
    return reduce_cfg(jax_config(arch)), reduce_cfg(get_config(arch))


@pytest.mark.parametrize("arch", ["xlstm-125m", "granite-8b", "zamba2-2.7b",
                                  "qwen2-moe-a2.7b", "whisper-medium",
                                  "internvl2-76b"])
def test_train_steps_match_jax(arch):
    jcfg, tcfg = _reduced(arch)
    jmodel, tmodel = jax_build(jcfg), build_model(tcfg, device="cpu")
    np_params = jax_params(jmodel, "float32")
    state = _carried_state(jax.tree.map(jnp.asarray, np_params))
    jstep = jmake_train_step(
        jmodel, JAdamWConfig(lr=jcosine(1e-2, 2, 8), weight_decay=0.1),
        None, None)
    if arch != "whisper-medium":
        jstep = jax.jit(jstep)
    tstep = make_train_step(tmodel, AdamWConfig(
        lr=cosine_with_warmup(1e-2, 2, 8), weight_decay=0.1))
    jp = jax.tree.map(jnp.asarray, np_params)
    js = jax.tree.map(jnp.asarray, state)
    tp = convert.to_torch(np_params, "cpu")
    ts = convert.adamw_state_to_torch(state, "cpu")
    data = JSyntheticLM(JDataConfig(vocab=jcfg.vocab, seq_len=S,
                                    global_batch=B, seed=0,
                                    encoder_len=jcfg.encoder_len,
                                    n_img_tokens=jcfg.n_img_tokens,
                                    d_model=jcfg.d_model))
    for step in range(STEPS):
        batch = data.global_batch_at(step)
        with jax.disable_jit(arch == "whisper-medium"):
            jp, js, jm = jstep(jp, js, jax.tree.map(jnp.asarray, batch))
        tp, ts, tm = tstep(tp, ts, convert.to_torch(batch, "cpu"))
        assert abs(tm["loss"].item() - float(jm["loss"])) <= \
            LOSS_TOL * abs(float(jm["loss"])), step
    assert int(ts["step"]) == int(js["step"]) == 4 + STEPS
    for got, want, start in zip(TL.tree_leaves(tp), jax.tree.leaves(jp),
                                jax.tree.leaves(np_params)):
        want, start = np.asarray(want, np.float64), np.asarray(start,
                                                              np.float64)
        moved = np.linalg.norm(want - start)
        assert moved > 0
        assert np.linalg.norm(got.double().numpy() - want) <= \
            UPDATE_TOL * moved


def test_train_cli_resumes(tmp_path, capsys):
    args = ["--arch", "xlstm-125m", "--tiny", "--device", "cpu",
            "--ckpt-every", "5", "--ckpt-dir", str(tmp_path)]
    first = train_cli.main(args + ["--steps", "12"])
    assert "improved" in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path)) == ["step_00000005.ckpt.zst",
                                            "step_00000010.ckpt.zst"]
    resumed = train_cli.main(args + ["--steps", "14"])
    assert "resumed at step 10" in capsys.readouterr().out
    # a checkpoint labelled 10 holds the state after 10 steps: the resumed
    # run's step 10 is the first run's (later steps differ: the schedule
    # spans 14 steps now)
    assert resumed[0] == first[10] and len(resumed) == 4


def test_train_cli_module_runs():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "zamba2-2.7b", "--tiny", "--device", "cpu", "--steps", "2",
         "--seq", "64", "--batch", "2"],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "arch=zamba2-2.7b" in proc.stdout and "loss" in proc.stdout


def test_example_runs(tmp_path):
    proc = subprocess.run(
        [sys.executable, "examples/train_small_lm_torch.py", "--tiny",
         "--device", "cpu", "--steps", "3", "--ckpt-dir", str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "step    2 loss=" in proc.stdout


# -- the kernels' autograd Function -----------------------------------------

@pytest.fixture
def plain_launches(monkeypatch):
    """Each wrapper's ``_launch`` replaced by its plain forward, so that
    the Function runs on the CPU as it does on the card."""
    monkeypatch.setattr(
        fa_mod, "_launch", lambda q, k, v, causal, window, softcap, bq, bk:
        flash_attention_ref(q, k, v, causal=causal, window=window,
                            softcap=softcap))
    monkeypatch.setattr(ssd_mod, "_launch", lambda x, la, b, c, chunk:
                        ssd_ref(x, la, b, c, chunk=chunk))


def _leaves(rng, shapes, dtype):
    return [torch.from_numpy(rng.standard_normal(s)).to(dtype)
            .requires_grad_() for s in shapes]


@pytest.mark.parametrize("mask", [dict(causal=True),
                                  dict(causal=True, window=3, softcap=5.0),
                                  dict(causal=False),
                                  dict(causal=False, sk=9)], ids=str)
def test_flash_function_gradients(plain_launches, mask):
    """Sq = Sk, and (``sk``) 7 queries over 9 keys without a mask, as an
    enc-dec's cross-attention trains it."""
    rng = np.random.default_rng(0)
    mask = dict(mask)
    sk = mask.pop("sk", 7)
    q, k, v = _leaves(rng, [(2, 7, 4, 8), (2, sk, 2, 8), (2, sk, 2, 8)],
                      torch.float32)
    before = tracing.counters()
    o = KernelFunction.apply(
        "flash_attention",
        lambda *t: fa_mod._launch(*t, mask.get("causal", True),
                                  mask.get("window"), mask.get("softcap"),
                                  None, None),
        lambda *t: flash_attention_ref(*t, **mask), q, k, v)
    go = torch.from_numpy(rng.standard_normal(o.shape).astype(np.float32))
    got = torch.autograd.grad(o, (q, k, v), go)
    want = torch.autograd.grad(flash_attention_ref(q, k, v, **mask),
                               (q, k, v), go)
    spent = tracing.counters() - before
    assert spent["flash_attention_backward_launches"] == 1
    for g, w in zip(got, want):
        assert torch.equal(g, w) and g.abs().sum() > 0


@pytest.mark.parametrize("outputs", ["y", "final", "both"])
def test_ssd_function_gradients(plain_launches, outputs):
    """b and c enter as stride-0 views of head-shared maps, as
    ``models/ssm.py`` gives them: their gradients sum over the heads."""
    rng = np.random.default_rng(1)
    Bn, Sn, H, P, N, chunk = 2, 6, 3, 4, 2, 4          # S pads to 8
    x, b1, c1 = _leaves(rng, [(Bn, Sn, H, P), (Bn, Sn, 1, N),
                              (Bn, Sn, 1, N)], torch.float32)
    la = torch.from_numpy(-np.abs(rng.standard_normal((Bn, Sn, H)))) \
        .float().requires_grad_()

    def run(fn, *args):
        bh, ch = (t.expand(Bn, Sn, H, N) for t in args[2:])
        y, final = fn(args[0], args[1], bh, ch)
        parts = {"y": [y], "final": [final], "both": [y, final]}[outputs]
        return sum((p * torch.linspace(-1, 1, p.numel(), dtype=p.dtype)
                    .reshape(p.shape)).sum() for p in parts)

    before = tracing.counters()
    inputs = (x, la, b1, c1)
    got = torch.autograd.grad(
        run(lambda *a: KernelFunction.apply(
            "ssd_scan", lambda *t: ssd_mod._launch(*t, chunk),
            lambda *t: ssd_ref(*t, chunk=chunk), *a), *inputs), inputs,
        allow_unused=True)
    want = torch.autograd.grad(
        run(lambda *a: ssd_ref(*a, chunk=chunk), *inputs), inputs,
        allow_unused=True)
    assert (tracing.counters() - before)["ssd_scan_backward_launches"] == 1
    for name, g, w in zip("x log_a b c".split(), got, want):
        if outputs == "final" and name == "c":
            assert g is None and w is None      # c takes no part in it
            continue
        assert torch.equal(g, w) and g.abs().sum() > 0, name


def test_decode_refuses_input_that_requires_grad():
    q = torch.randn(2, 4, 8, requires_grad=True)
    k = v = torch.randn(2, 6, 2, 8)
    lengths = torch.tensor([3, 6], dtype=torch.int32)
    with pytest.raises(ValueError, match="no backward"):
        da_mod.decode_attention(q, k, v, lengths)
    with torch.no_grad():
        assert da_mod.decode_attention(q, k, v, lengths).shape == (2, 4, 8)
