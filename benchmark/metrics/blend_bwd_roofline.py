"""K2's share of its roofline (%): over every fifth K2 launch of the slice,
the sum of the launches' least times on the card (``work.py``) over the sum
of their device times (the reduce kernel is not part of K2's time)."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _common import roofline  # noqa: E402


def read(run):
    return roofline(run, "bwd")
