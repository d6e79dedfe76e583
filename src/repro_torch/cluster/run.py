"""Deprecated scenario-runner entry point.

``python -m repro_torch.cluster.run`` is a thin delegate of the unified CLI
— ``python -m repro_torch sim`` (see :mod:`repro_torch.cli`).  Flags and
stdout bytes are the same; a deprecation note goes to stderr.
``check_schema`` / ``SCHEMA_KEYS`` live in :mod:`repro_torch.cluster.control`
and are re-exported here for backward compatibility.

  PYTHONPATH=src python -m repro_torch.cluster.run --scenario smoke \
      [--device cpu]
"""
from __future__ import annotations

import sys

from repro_torch.cli import deprecation_note, sim_main
from repro_torch.cluster.control import (REPORT_SCHEMA,  # noqa: F401
                                         SCHEMA_KEYS, check_schema)


def main(argv=None) -> int:
    deprecation_note("python -m repro_torch.cluster.run",
                     "python -m repro_torch sim")
    return sim_main(argv, prog="python -m repro_torch.cluster.run")


if __name__ == "__main__":
    sys.exit(main())
