"""``python -m monkey_moore_tpu_torch COMMAND ...``: the port's CLI."""

import sys

from .cli import main

sys.exit(main())
