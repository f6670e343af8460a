"""The benchmark's CPU tests: run from the checkout's root with
``python -m pytest wabench/tests`` (the program's package is under
``src/``)."""

import pathlib
import sys

_ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (_ROOT, _ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
