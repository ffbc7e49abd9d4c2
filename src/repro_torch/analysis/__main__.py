"""``python -m repro_torch.analysis``: the port's scission-lint entry
point."""

import sys

from .cli import main

sys.exit(main())
