"""The benchmark's own tests run on the CPU: the harness's look for a GPU is
skipped by calling it with ``require_gpu=False``; tests that need the card
carry the ``gpu`` marker and skip inside the test elsewhere."""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
