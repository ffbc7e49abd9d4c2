"""Shared set-up of the harness's own tests: the harness and the port on
``sys.path``, and tiny sizes at which a whole run fits on the CPU."""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (os.path.join(ROOT, "src"), BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

# tiny sizes: every width cut, the structure (GQA, tied embedding, exact
# admission, the shared block every 6 Mamba-2 layers) kept
TINY = {
    "granite-8b.chat": (
        {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
         "head_dim": 16, "d_ff": 128, "vocab": 256},
        {"engine": {"width": 4, "max_len": 128, "prompt_buckets": None},
         "traffic": {"rate_rps": 4.0, "warmup_s": 0.5,
                     "prompt_len": {"dist": "log_uniform", "lo": 8,
                                    "hi": 40},
                     "new_tokens": {"dist": "log_uniform", "lo": 4,
                                    "hi": 12}},
         "profile_s": 0.5, "check": {"sample_tokens": 40}}),
    "zamba2-2.7b-simplified.train-4k": (
        {"n_layers": 12, "d_model": 64, "n_heads": 4, "n_kv_heads": 4,
         "head_dim": 16, "d_ff": 128, "vocab": 256, "ssm_state": 16,
         "ssm_head_dim": 16, "ssm_chunk": 16, "loss_seq_chunk": 32},
        {"train": {"seq": 64, "batch": 2}}),
}
