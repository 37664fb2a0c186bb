"""The benchmark's own tests: `python -m pytest npbench/tests -q` from the
root of the repo (the card-only ones, marked gpu, skip without a card)."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
