"""test_torch_lm_bf16.py's check on the other four reduced configs of
test_torch_lm.py (starcoder2-15b, zamba2-2.7b, internvl2-76b, xlstm-125m),
in a file of their own so that the two halves run side by side."""

import pytest

from test_torch_lm import ARCHS
from test_torch_lm_bf16 import CASES, check_bf16


@pytest.mark.parametrize("arch", [a for a in ARCHS if a not in CASES])
def test_bf16_is_as_close_to_fp32_as_the_reference(arch):
    check_bf16(arch)
