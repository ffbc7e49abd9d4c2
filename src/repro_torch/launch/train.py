"""Training launcher: the port of ``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \
        --tiny --steps 50 --ckpt-dir CKPT_DIR [--device cpu]

The reference's flags and one more, ``--device`` (default ``cuda``: the
kernels run on the card).  Each step is :func:`.steps.make_train_step`'s:
the loss, its gradient through the kernels (their plain versions on the
CPU), AdamW in place.  Fault tolerance is live: checkpoint/restart through
``CheckpointManager`` and ``TrainSupervisor``.  A checkpoint labelled N
holds the state after N steps, and a resumed run goes on at step N.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..checkpoint import CheckpointManager
from ..data import DataConfig, SyntheticLM
from ..models import build_model, get_config
from ..optim import AdamWConfig, cosine_with_warmup, init_state
from ..runtime.ft import TrainSupervisor
from .steps import count_params, make_train_step


def tiny(cfg):
    """The reference's tiny model of ``cfg``."""
    return cfg.replace(
        n_layers=len(cfg.pattern) * 2 if not cfg.shared_attn_period
        else cfg.shared_attn_period,
        d_model=128, n_heads=4,
        n_kv_heads=min(4, cfg.n_kv_heads), head_dim=32,
        d_ff=0 if cfg.d_ff == 0 else 256, vocab=512,
        moe_experts=8 if cfg.moe_experts else 0,
        moe_top_k=min(2, cfg.moe_top_k) if cfg.moe_top_k else 0,
        moe_shared_dff=64 if cfg.moe_shared_dff else 0,
        moe_group_size=64, ssm_chunk=32, ssm_head_dim=16,
        encoder_layers=2 if cfg.is_encdec else 0,
        encoder_len=32 if cfg.is_encdec else cfg.encoder_len,
        n_img_tokens=4 if cfg.n_img_tokens else 0,
        window=16 if cfg.window else None,
        query_pre_attn_scalar=32.0 if cfg.query_pre_attn_scalar else None,
        remat=False, q_chunk=64, loss_seq_chunk=None)


def device_batch(cfg, batch: dict, device) -> dict:
    """A numpy batch of the data pipeline as tensors on ``device``, with
    patch embeddings and frames in bf16, as the reference feeds them."""
    out = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    for key in ("patch_embeds", "frames"):
        if key in out:
            out[key] = out[key].to(torch.bfloat16)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.tiny:
        cfg = tiny(cfg)
    model = build_model(cfg, device=args.device)
    print(f"arch={cfg.name} params={count_params(cfg):,}")

    data = SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
        encoder_len=cfg.encoder_len if cfg.is_encdec else 0,
        n_img_tokens=cfg.n_img_tokens, d_model=cfg.d_model))
    adamw = AdamWConfig(lr=cosine_with_warmup(args.lr, 10, args.steps))
    step_fn = make_train_step(model, adamw)

    params = model.init(seed=0)
    opt = init_state(params)
    start = 0
    sup = None
    if args.ckpt_dir:
        sup = TrainSupervisor(CheckpointManager(args.ckpt_dir, keep=2),
                              ckpt_every=args.ckpt_every)
        state = {"p": params, "o": opt}
        state, start = sup.resume_or_init(lambda: state, like=state)
        params, opt = state["p"], state["o"]
        if start:
            print(f"resumed at step {start}")

    losses = []
    for step in range(start, args.steps):
        batch = device_batch(cfg, data.global_batch_at(step), model.device)
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, batch)
        losses.append(float(metrics["loss"]))
        wall = time.perf_counter() - t0
        if sup:
            # the state after step + 1 steps, labelled so
            sup.after_step(step + 1, {"p": params, "o": opt}, wall)
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss={losses[-1]:.4f} "
                  f"{wall * 1e3:.0f}ms")
    if sup:
        sup.ckpt.wait()
    first = sum(losses[:5]) / max(len(losses[:5]), 1)
    last = sum(losses[-5:]) / max(len(losses[-5:]), 1)
    print(f"loss {first:.3f} -> {last:.3f} "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")
    return losses


if __name__ == "__main__":
    main()
