"""A stand-in for the kernel library (``runtime/kernels.library()``) and the
``meta_library`` fixture that puts it in place: the kernel wrappers' tests
run on the meta device (or on host memory) with no compiler and no card,
and read which C entries were launched, with what, on which device.
Imports nothing of JAX, so the card's tests can use it."""

import contextlib

import pytest
import torch

from aat_tpu_torch.runtime import kernels


class RecordingLibrary:
    """Stands in for the kernel library: records each C entry's name, its
    arguments and the device made current around the call, and checks the
    argument count against the ctypes signature."""

    def __init__(self):
        self.names, self.args, self.devices = [], [], []
        self.current = None  # the device of the innermost torch.cuda.device

    def call(self, name, *args):
        assert len(args) == len(kernels._SIGNATURES[name]), name
        self.names.append(name)
        self.args.append(args)
        self.devices.append(self.current)

    @contextlib.contextmanager
    def device_guard(self, device):
        outer, self.current = self.current, device
        try:
            yield
        finally:
            self.current = outer


@pytest.fixture
def meta_library(monkeypatch):
    lib = RecordingLibrary()
    monkeypatch.setattr(kernels, "check_cuda", lambda x, kernel: None)  # meta stands in for CUDA
    monkeypatch.setattr(kernels, "library", lambda: lib)
    monkeypatch.setattr(kernels, "stream_handle", lambda device: ("stream", device))
    monkeypatch.setattr(torch.cuda, "device", lib.device_guard)
    return lib
