"""The benchmark's CPU tests: the repository's ``src`` and root on the
path (``cells.py`` cuts each cell to a test's size)."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
