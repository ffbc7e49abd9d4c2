"""The port's decoder-only LMs against the JAX package's in bf16, on the CPU.

Five reduced configs of test_torch_lm.py, the first three and the MoE and
xLSTM families' qwen2-moe-a2.7b and granite-moe-3b-a800m (the other four
are in test_torch_lm_bf16_cells.py), with the same parameter values in
bf16.
Both packages round every operation to bf16, but in other places (XLA
fuses elementwise chains and rounds at the fusion's end, PyTorch rounds
each operator), so their bf16 logits differ by bf16 noise, which
for zamba2's Mamba-2 layers is about 5% of the logits' norm in either
package.  Each stage's logits are therefore held by relative norm error
against the JAX model run in fp32 on the same bf16 parameter values: the
port's error may exceed the JAX package's own bf16 error by at most 3e-2
(tests/test_kernels.py:18-19).
"""

import numpy as np
import pytest

from test_torch_lm import ARCHS, run_both

CASES = ARCHS[:3] + ARCHS[6:8]
TOL = 3e-2


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def check_bf16(arch):
    port = run_both(arch, "bfloat16")
    ref32 = run_both(arch, "bfloat16", jax_dtype="float32")
    for (stage, got, want), (_, _, truth) in zip(port, ref32):
        assert got.shape == want.shape == truth.shape, stage
        got = got.float().numpy()
        e_port, e_jax = _rel(got, truth), _rel(want, truth)
        assert e_port <= e_jax + TOL, (stage, e_port, e_jax)


@pytest.mark.parametrize("arch", CASES)
def test_bf16_is_as_close_to_fp32_as_the_reference(arch):
    check_bf16(arch)
