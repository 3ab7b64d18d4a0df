"""perfbench's own tests: run from the checkout's root with

    python -m pytest perfbench/tests -q            (CPU)
    python -m pytest perfbench/tests -q -m cuda    (on the card)

The checkout's root goes on sys.path so `perfbench` and the program import
as run.py imports them."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
