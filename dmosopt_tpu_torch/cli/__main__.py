"""``python -m dmosopt_tpu_torch.cli <command> ...``."""

import sys

from dmosopt_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
