"""Deprecated profiling-campaign entry point.

``python -m repro_torch.profiling.run`` is a thin delegate of the unified
CLI — ``python -m repro_torch profile`` (see :mod:`repro_torch.cli`).  Flags
and stdout bytes (the speed-matrix artifact) are the same; a deprecation
note goes to stderr.

  PYTHONPATH=src python -m repro_torch.profiling.run --suite smoke \
      [--device cpu]
"""
from __future__ import annotations

import sys

from repro_torch.cli import deprecation_note, profile_main


def main(argv=None) -> int:
    deprecation_note("python -m repro_torch.profiling.run",
                     "python -m repro_torch profile")
    return profile_main(argv, prog="python -m repro_torch.profiling.run")


if __name__ == "__main__":
    sys.exit(main())
