"""`python -m gifgan_tpu_torch` -> cli.main."""

import sys

from gifgan_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
