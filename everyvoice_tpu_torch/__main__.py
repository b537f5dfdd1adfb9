"""``python -m everyvoice_tpu_torch``: the port's command line (``cli.py``)."""

import sys

from everyvoice_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
