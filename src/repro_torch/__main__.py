"""``python -m repro_torch`` — the port's CLI front door (see repro_torch.cli)."""
import sys

from repro_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
