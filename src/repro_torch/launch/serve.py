"""Serving launcher: batched greedy generation through the port's engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
        --requests 8 --width 4 [--device cpu]

The port of ``repro/launch/serve.py``, with its flags and one more,
``--device`` (default ``cuda``: the kernels run on the card).  As there,
``--tiny`` is a ``store_true`` flag whose default is True, so the model is
always the tiny one of :func:`.train.tiny`.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..models import build_model, get_config
from ..serving import Request, ServingEngine
from .train import tiny


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--tiny", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--width", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.tiny:
        cfg = tiny(cfg)
    if cfg.is_encdec or cfg.n_img_tokens:
        raise SystemExit("serve CLI supports decoder-only archs; use the "
                         "examples for enc-dec")
    model = build_model(cfg, device=args.device)
    params = model.init(seed=0)

    eng = ServingEngine(model, params, width=args.width,
                        max_len=args.max_len)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for rid in range(args.requests):
        eng.submit(Request(
            rid=rid, prompt=rng.integers(0, cfg.vocab,
                                         int(rng.integers(4, 16))),
            max_new_tokens=args.max_new))
    done = eng.run()
    wall = time.perf_counter() - t0
    n_tok = sum(len(r.tokens) for r in done)
    print(f"served {len(done)} requests, {n_tok} tokens in "
          f"{wall:.2f}s ({n_tok / wall:.1f} tok/s aggregate)")
    ttfts = [r.first_token_at - r.submitted_at for r in done]
    print(f"TTFT p50={np.percentile(ttfts, 50) * 1e3:.0f}ms "
          f"p95={np.percentile(ttfts, 95) * 1e3:.0f}ms")


if __name__ == "__main__":
    main()
