#!/usr/bin/env python
"""Thin wrapper for ``python -m repro_torch.analysis.lint`` that works
from a fresh checkout without PYTHONPATH: it puts the ``src`` folder
that holds this package on the path.  All arguments pass through — see
``--help``."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from repro_torch.analysis.lint import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
