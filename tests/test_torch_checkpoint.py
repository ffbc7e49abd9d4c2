"""The port's checkpoint against the JAX package's: the same file format.

Round trips (bf16 included, bit for bit), files written by either
package's ``save`` restored by the other bit for bit, the port's msgpack
encoder giving the bytes of ``msgpack.packb(..., use_bin_type=True)`` and
its decoder the objects of ``msgpack.unpackb``, and the manager's
retention, async writes and latest-step resume.
"""

import threading

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt

from repro_torch.checkpoint import CheckpointManager, ckpt, restore, save
from repro_torch.convert import to_torch
from repro_torch.models import layers as TL
from repro_torch.runtime.ft import TrainSupervisor


def _np_tree():
    rng = np.random.default_rng(0)
    return {"b": {"c": np.arange(5, dtype=np.int32),
                  "a": rng.standard_normal((3, 4)).astype(np.float32)},
            "a": rng.standard_normal((2, 3)).astype(jnp.bfloat16),
            "step": np.asarray(7, np.int32)}


def _equal(got, want):
    """Leaf by leaf, bit for bit (bf16 through its uint16 view)."""
    gl, wl = TL.tree_leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        w = np.asarray(w)
        if w.dtype == jnp.bfloat16:
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                g.view(torch.int16).numpy().view(np.uint16),
                w.view(np.uint16))
        else:
            assert g.numpy().dtype == w.dtype
            np.testing.assert_array_equal(g.numpy(), w)


def test_roundtrip_bf16(tmp_path):
    tree = to_torch(_np_tree(), "cpu")
    p = str(tmp_path / "x.ckpt.zst")
    save(p, tree, step=7, meta={"note": "hi", "n": [1, 2.5, None]})
    got, step, meta = restore(p, tree)
    assert step == 7 and meta == {"note": "hi", "n": [1, 2.5, None]}
    assert list(got) == list(tree) and list(got["b"]) == ["c", "a"]
    _equal(got, _np_tree())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_files_interoperate(tmp_path, writer):
    tree = _np_tree()
    p = str(tmp_path / "x.ckpt.zst")
    if writer == "jax":
        jckpt.save(p, jax.tree.map(jnp.asarray, tree), step=3,
                   meta={"by": "jax"})
        got, step, meta = restore(p, to_torch(tree, "cpu"))
        _equal(got, tree)
    else:
        save(p, to_torch(tree, "cpu"), step=3, meta={"by": "port"})
        got, step, meta = jckpt.restore(p, tree)
        _equal(to_torch(got, "cpu"), tree)
    assert step == 3 and meta == {"by": writer}


def test_encoder_gives_msgpack_bytes():
    tree = to_torch(_np_tree(), "cpu")
    payload = {"step": 123456, "meta": {"lr": 3e-4, "ok": True, "x": None,
                                        "neg": -40000, "s": "é" * 40},
               "leaves": [ckpt._encode_leaf(x) for x in TL.tree_leaves(tree)]}
    payload["leaves"].append({"dtype": "<f4", "shape": [70000],
                              "data": bytes(280000)})
    raw = msgpack.packb(payload, use_bin_type=True)
    assert ckpt.packb(payload) == raw
    assert ckpt.unpackb(raw) == msgpack.unpackb(raw, raw=False)


def test_manager_retention_and_resume(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_writes=False)
    tree = {"w": torch.zeros(2)}
    for s in (10, 20, 30):
        mgr.save(s, {"w": tree["w"] + s})
    assert mgr.steps() == [20, 30]
    got, step, _ = mgr.restore_latest(tree)
    assert step == 30 and torch.equal(got["w"], torch.full((2,), 30.0))


def test_async_save_copies_before_returning(tmp_path):
    """The writer serialises a copy taken at the call: the caller may go on
    updating its tensors in place."""
    mgr = CheckpointManager(str(tmp_path), keep=1, async_writes=True)
    w = torch.ones(64, 64)
    started = threading.Event()
    real = ckpt.save

    def slow_save(*a, **k):
        started.wait(timeout=30)
        return real(*a, **k)

    ckpt.save = slow_save
    try:
        mgr.save(1, {"w": w})
        w.add_(1.0)                        # the next step's in-place update
        started.set()
        mgr.wait()
    finally:
        ckpt.save = real
    assert mgr.steps() == [1]
    got, step, _ = mgr.restore_latest({"w": w})
    assert step == 1 and torch.equal(got["w"], torch.ones(64, 64))


def test_async_write_error_reaches_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=1, async_writes=True)
    mgr.save(1, {"w": object()})           # no tensor: the writer raises
    with pytest.raises(RuntimeError, match="infer dtype"):
        mgr.wait()
    mgr.wait()                             # raised once


def test_supervisor_resumes_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_writes=True)
    sup = TrainSupervisor(mgr, ckpt_every=5)
    state = {"w": torch.zeros(2)}
    for step in range(1, 11):
        state = {"w": state["w"] + 1}
        sup.after_step(step, state, wall_s=0.1)
    mgr.wait()
    got, step = TrainSupervisor(mgr, ckpt_every=5).resume_or_init(
        lambda: {"w": torch.zeros(2)}, like=state)
    assert step == 10 and torch.equal(got["w"], torch.full((2,), 10.0))
