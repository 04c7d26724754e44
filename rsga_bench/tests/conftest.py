"""The benchmark's CPU tests: the checkout's root (for ``rsga_bench``) and
``src`` (for the program) on the path."""
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
