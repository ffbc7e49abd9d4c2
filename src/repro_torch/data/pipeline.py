"""Deterministic synthetic data pipeline (shardable per host, restartable):
the port of ``repro/data/pipeline.py``, numpy only, so its batches equal
the reference's exactly.

Produces the same token stream for a given (seed, step) regardless of host
count — each host materialises only its shard of the global batch, which is
what a 1000-node fleet needs (no host reads the full batch).  Restart after
failure resumes from the step counter alone (no iterator state to persist,
a deliberate fault-tolerance property; see runtime/ft.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # modality extras
    encoder_len: int = 0
    n_img_tokens: int = 0
    d_model: int = 0


class SyntheticLM:
    """Markov-ish synthetic LM stream: next token depends on the previous
    one through a fixed random permutation + noise, so a real model can
    actually reduce loss on it (used by the training examples)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self._perm = rng.permutation(cfg.vocab)

    def global_batch_at(self, step: int) -> dict[str, np.ndarray]:
        return self.host_batch_at(step, host_id=0, n_hosts=1)

    def host_batch_at(self, step: int, host_id: int, n_hosts: int
                      ) -> dict[str, np.ndarray]:
        cfg = self.cfg
        assert cfg.global_batch % n_hosts == 0
        b = cfg.global_batch // n_hosts
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 4096 + host_id)
        first = rng.integers(0, cfg.vocab, size=(b, 1))
        toks = [first]
        for _ in range(cfg.seq_len):
            prev = toks[-1]
            nxt = self._perm[prev]
            noise = rng.integers(0, cfg.vocab, size=prev.shape)
            use_noise = rng.random(prev.shape) < 0.1
            toks.append(np.where(use_noise, noise, nxt))
        seq = np.concatenate(toks, axis=1)
        out = {"tokens": seq[:, :-1].astype(np.int32),
               "labels": seq[:, 1:].astype(np.int32)}
        if cfg.encoder_len:
            out["frames"] = rng.standard_normal(
                (b, cfg.encoder_len, cfg.d_model)).astype(np.float32)
        if cfg.n_img_tokens:
            out["patch_embeds"] = rng.standard_normal(
                (b, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
        return out


def make_iterator(cfg: DataConfig, start_step: int = 0, host_id: int = 0,
                  n_hosts: int = 1):
    ds = SyntheticLM(cfg)
    step = start_step
    while True:
        yield step, ds.host_batch_at(step, host_id, n_hosts)
        step += 1
