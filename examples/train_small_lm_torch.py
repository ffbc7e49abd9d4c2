"""Train a ~100M-parameter xLSTM on the synthetic pipeline for a few
hundred steps with checkpoint/restart: the port of
``examples/train_small_lm.py``.

    PYTHONPATH=src python examples/train_small_lm_torch.py --steps 200
    PYTHONPATH=src python examples/train_small_lm_torch.py --tiny --steps 30 \
        --device cpu

``--tiny`` shrinks the model (~1M params) so the example finishes in
seconds on the CPU; the default config is the real xlstm-125m geometry,
whose mLSTMs run ``ssd_scan``'s wide route on the card.  ``--device``
defaults to ``cuda``.  Interrupt and re-run to see checkpoint resume
(``runtime/ft.py``); the checkpoints go under ``--ckpt-dir``, by default a
directory in the system's temporary directory.
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, "src")

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.launch.train import device_batch  # noqa: E402
from repro_torch.models import build_model, get_config  # noqa: E402
from repro_torch.optim import (AdamWConfig, cosine_with_warmup,  # noqa: E402
                               init_state)
from repro_torch.runtime.ft import TrainSupervisor  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config("xlstm-125m").replace(remat=False,
                                           loss_seq_chunk=None)
    if args.tiny:
        cfg = cfg.replace(d_model=128, n_heads=4, head_dim=32, vocab=512,
                          n_layers=4, ssm_chunk=32)
    model = build_model(cfg, device=args.device)

    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch, seed=0))
    adamw = AdamWConfig(lr=cosine_with_warmup(3e-3, 20, args.steps),
                        weight_decay=0.01)
    step_fn = make_train_step(model, adamw)

    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    sup = TrainSupervisor(mgr, ckpt_every=50)

    params = model.init(seed=0)
    opt = init_state(params)
    state, start = sup.resume_or_init(lambda: {"p": params, "o": opt},
                                      like={"p": params, "o": opt})
    params, opt = state["p"], state["o"]
    if start:
        print(f"resumed from checkpoint at step {start}")

    for step in range(start, args.steps):
        batch = device_batch(cfg, data.global_batch_at(step), model.device)
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, batch)
        loss = float(metrics["loss"])
        wall = time.perf_counter() - t0
        # the state after step + 1 steps, labelled so
        sup.after_step(step + 1, {"p": params, "o": opt}, wall)
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss={loss:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"lr={float(metrics['lr']):.2e} {wall * 1e3:.0f}ms")
    mgr.wait()
    print("events:", sup.events[-4:])


if __name__ == "__main__":
    main()
