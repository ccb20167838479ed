"""Pytest settings of the benchmark's own tests: the ``card`` marker for
tests that need a CUDA device. Whether there is one is decided inside the
``card`` fixture, when a test runs, never while modules are collected."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (run on the chip)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; runs on the chip")
    return torch.device("cuda", 0)


@pytest.fixture
def cpu_threads():
    """Two torch threads and no oneDNN (whose bf16 grouped conv is wrong on
    the CPU), restored after the test."""
    import torch

    threads, mkldnn = torch.get_num_threads(), torch.backends.mkldnn.enabled
    torch.set_num_threads(2)
    torch.backends.mkldnn.enabled = False
    yield
    torch.set_num_threads(threads)
    torch.backends.mkldnn.enabled = mkldnn
