"""The port's data pipeline against the JAX package's: numpy alike, so the
batches are equal, frames and patch embeddings included."""

import numpy as np
import pytest

from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.data import make_iterator as jmake_iterator

from repro_torch.data import DataConfig, SyntheticLM, make_iterator

CASES = [  # seed, step, host, n_hosts, encoder_len, n_img_tokens
    (0, 0, 0, 1, 0, 0),
    (3, 5, 1, 4, 0, 0),
    (7, 123, 3, 4, 0, 0),
    (1, 9, 0, 2, 6, 0),
    (2, 4, 1, 2, 0, 3),
]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_batches_equal_reference(case):
    seed, step, host, n_hosts, enc, img = case
    kw = dict(vocab=97, seq_len=12, global_batch=8, seed=seed,
              encoder_len=enc, n_img_tokens=img, d_model=16 if enc or img
              else 0)
    want = JSyntheticLM(JDataConfig(**kw)).host_batch_at(step, host, n_hosts)
    got = SyntheticLM(DataConfig(**kw)).host_batch_at(step, host, n_hosts)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


def test_iterator_equals_reference():
    cfg = dict(vocab=64, seq_len=8, global_batch=2, seed=5)
    jit = jmake_iterator(JDataConfig(**cfg), start_step=3, host_id=1,
                         n_hosts=2)
    tit = make_iterator(DataConfig(**cfg), start_step=3, host_id=1,
                        n_hosts=2)
    for _ in range(3):
        (js, jb), (ts, tb) = next(jit), next(tit)
        assert js == ts
        for key in jb:
            np.testing.assert_array_equal(tb[key], jb[key])
