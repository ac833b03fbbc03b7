"""Tests of the benchmark harness. Run from the repository root:

    python -m pytest benchmark/tests -q

on the CPU (the card tests skip), and on a card machine the same command
runs the tests marked `cuda` too. Nothing here imports JAX.
"""
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where "
        "torch.cuda.is_available() is false")


@pytest.fixture
def card():
    """Skip the test unless a CUDA device is there (decided when the test
    runs, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def tiny_inputs():
    """(cell, configuration, traffic, limits) of the tiny CPU stand-in of
    `restore-1024x1536`: the same cell and limits, the tiny widths."""
    import harness

    spec = harness.load_spec()
    w, _, _, limits = harness.cell_inputs(spec, "restore-1024x1536")
    here = os.path.dirname(os.path.abspath(__file__))
    return (w, harness.load_json(os.path.join(here, "tiny_config.json")),
            harness.load_json(os.path.join(here, "tiny_traffic.json")), limits)
