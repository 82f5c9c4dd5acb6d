"""K1's share of its roofline (%): over a fixed sample of the slice's
residual-mode launches (every fifth K1 launch that is one), the sum of each
launch's least time on the card (``work.py``: FP32 operations at 67 TFLOP/s
or bytes at 3.35 TB/s, the larger) over the sum of their device times."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _common import roofline  # noqa: E402


def read(run):
    return roofline(run, "residual")
