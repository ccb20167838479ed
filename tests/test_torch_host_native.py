"""The port's native host route (``aat_tpu_torch/csrc/aat_host.cpp``, built
with this machine's ``g++`` by ``runtime/native``) against its numpy
routes and the JAX package's ``load_library()`` route: each of the five
entry points bitwise equal (mirrors ``tests/test_runtime.py``). Also: the
route counters, the numpy fallback with a warning where nothing builds, and
the collator, the host tokenizer and WER going through the native route."""

import logging
import os

import numpy as np
import pytest

from aat_tpu.runtime import host_ops as jhost
from aat_tpu.runtime import load_library as jload
from aat_tpu.training import metrics as jmetrics
from aat_tpu_torch.runtime import host_ops, native
from aat_tpu_torch.runtime.kernels import BUILD_DIR
from aat_tpu_torch.training import metrics as tmetrics
from tests.conftest import make_speechlike_waveform


def cases():
    """Per entry point: its arguments (seeded, as ``tests/test_runtime.py``)."""
    rng = np.random.default_rng(0)
    waveform = rng.normal(0, 1, 5000).astype(np.float32)
    ids = np.random.default_rng(1)
    return {
        "assemble_segments": [(waveform, np.array([0, 1200, 2000, 4900]),
                               np.array([1200, 2000, 4500, 5000]),
                               np.array([1200, 800, 2500, 2000]), 2600)],
        "normalize_pad": [([rng.normal(3, 2, 1000), rng.normal(-1, 0.1, 700),
                            rng.normal(0, 1, 1600)],)],
        "smoothed_amplitude": [(rng.normal(30, 20, 6000).astype(np.float32), 12),
                               (rng.normal(30, 20, 10).astype(np.float32), 12)],
        "find_minima": [((np.sin(np.linspace(0, 60, 4000)) * 30
                          + rng.normal(0, 5, 4000)).astype(np.float32), 1e-5, 15.0),
                        (np.array([20.0, 30.0], np.float32), 1e-5, 15.0)],
        "edit_distance": [(ids.integers(0, 10, ids.integers(0, 30)),
                           ids.integers(0, 10, ids.integers(1, 30))) for _ in range(20)],
    }


def as_list(result):
    return list(result) if isinstance(result, tuple) else [result]


def test_library_builds_into_the_build_directory():
    lib = native.library()
    assert lib is not None and jload() is not None
    assert os.path.dirname(lib.path) == BUILD_DIR
    assert os.path.basename(lib.path) == os.path.basename(native.library_path())
    assert all(callable(getattr(lib, name)) for name in host_ops.ENTRIES)


@pytest.mark.parametrize("name", host_ops.ENTRIES)
def test_entry_point_bitwise_equals_numpy_and_jax_routes(monkeypatch, name):
    host_ops.reset_calls()
    native_out = [as_list(getattr(host_ops, name)(*args)) for args in cases()[name]]
    assert host_ops.calls["native"][name] == len(cases()[name])
    jax_native = [as_list(getattr(jhost, name)(*args)) for args in cases()[name]]
    monkeypatch.setattr(native, "library", lambda: None)
    monkeypatch.setattr(jhost, "load_library", lambda: None)
    numpy_out = [as_list(getattr(host_ops, name)(*args)) for args in cases()[name]]
    assert host_ops.calls["numpy"][name] == len(cases()[name])
    jax_numpy = [as_list(getattr(jhost, name)(*args)) for args in cases()[name]]
    for got, *wants in zip(native_out, numpy_out, jax_native, jax_numpy):
        for want in wants:
            assert len(got) == len(want)
            for g, w in zip(got, want):
                if isinstance(w, np.ndarray):
                    assert g.dtype == w.dtype and g.shape == w.shape, name
                np.testing.assert_array_equal(g, w, err_msg=name)


def test_assemble_segments_past_the_row_end_zero_fills_on_both_routes(monkeypatch):
    """A padded trailing segment whose end lies past the waveform (the
    adaptive collator asks for one on the batch's longest row): the native
    route zero-fills past the end, as JAX's native route (the one that
    runs) does, and the port's numpy route now does too (JAX's numpy
    fallback repeats the last sample there)."""
    wave = np.random.default_rng(2).normal(0, 1, 7200).astype(np.float32)
    args = (wave, np.array([0, 4000, 7000]), np.array([4000, 8000, 9000]),
            np.array([4000, 4000, 2000]), 4000)
    native_out = host_ops.assemble_segments(*args)
    jax_native = jhost.assemble_segments(*args)
    monkeypatch.setattr(native, "library", lambda: None)
    numpy_out = host_ops.assemble_segments(*args)
    for got in (numpy_out, jax_native):
        for g, w in zip(got, native_out):
            np.testing.assert_array_equal(g, w)
    segments = native_out[0]
    np.testing.assert_array_equal(segments[1, :3200], wave[4000:])
    assert not segments[1, 3200:].any() and not segments[2, 200:].any()
    monkeypatch.setattr(jhost, "load_library", lambda: None)
    assert jhost.assemble_segments(*args)[0][1, 3200] == wave[-1] != 0.0


def test_no_compiler_falls_back_to_numpy_with_a_warning(monkeypatch, tmp_path, caplog):
    monkeypatch.setattr(native, "_library", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "library_path", lambda: str(tmp_path / "libaat_host.so"))
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++ on it
    with caplog.at_level(logging.WARNING, logger="aat_tpu_torch.runtime.native"):
        assert native.library() is None
    assert "numpy routes" in caplog.text
    host_ops.reset_calls()
    x = np.array([20.0, 30.0, 16.0, 40.0, 1.0], np.float32)
    np.testing.assert_array_equal(host_ops.find_minima(x), [1, 3])
    assert host_ops.calls["numpy"]["find_minima"] == 1
    assert host_ops.calls["native"]["find_minima"] == 0


def test_collator_tokenizer_and_wer_take_the_native_route():
    from aat_tpu_torch.data.collate import TokenizedAudioWaveformCollator
    from aat_tpu_torch.tokenizer import AdaptiveAudioTokenizer
    from tests.test_collate import WordTokenizer, make_item

    rng = np.random.default_rng(4)
    items = [make_item(rng, d, n_words=6) for d in (1.5, 2.2)]
    collate = TokenizedAudioWaveformCollator(
        "hubert", "adaptive", AdaptiveAudioTokenizer.create(max_segment_duration_milliseconds=250),
        WordTokenizer(), uniform_segmentation_frames_per_segment=4000, seed=0)
    host_ops.reset_calls()
    collate(items)
    AdaptiveAudioTokenizer().segment_spans(make_speechlike_waveform(rng, 2.0))
    preds = ["a b c d", "the cat sat", ""]
    refs = ["a c d e", "the cat sat down", "x y"]
    assert tmetrics.wer(preds, refs) == jmetrics.wer(preds, refs) == 0.5
    counts = host_ops.calls
    assert counts["native"]["normalize_pad"] == 1
    assert counts["native"]["assemble_segments"] == len(items)
    assert counts["native"]["smoothed_amplitude"] >= 1 and counts["native"]["find_minima"] >= 1
    assert counts["native"]["edit_distance"] == len(preds)
    assert sum(counts["numpy"].values()) == 0
