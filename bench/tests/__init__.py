"""CPU tests of the benchmark's harness. They import the harness as
``bench`` and the program from ``src``, run from the repository's root:
``python -m pytest -q bench/tests``."""
import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[2]
for _p in (str(_ROOT / "src"), str(_ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)
