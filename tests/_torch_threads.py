"""The port's test files' thread count, kept apart from the JAX package."""

import pytest
import torch


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads a test, in every module that imports this: the
    test workers share the host's cores, and many-threaded small ops and
    convolutions on shared cores run far slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)
