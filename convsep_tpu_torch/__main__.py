"""``python -m convsep_tpu_torch <verb> ...``: the command-line interface."""

import sys

from convsep_tpu_torch.cli import main

sys.exit(main())
