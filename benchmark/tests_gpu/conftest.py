"""Tests that need the card: they run on the GPU JAX finds, and skip inside
the test where there is none.  ``python -m pytest -m gpu
benchmark/tests_gpu``."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
