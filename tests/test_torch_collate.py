"""The port's collators (``aat_tpu_torch/data/collate.py``) against the
JAX package's on the same items and seed: every field of every batch equal
element for element, over a run of batches from one collator (one random
stream: the batch's ``n_words``, then per item noise, crop and prefix), for
uniform and adaptive boundaries, the ``n_words`` crop, noise, the memory-
mapped melspec cache, ``is_validation`` and text / segment bucketing; and
the whole-utterance collator. Mirrors ``tests/test_collate.py``."""

import os

import numpy as np
import pytest

from aat_tpu.data import collate as jcollate
from aat_tpu.ops.mel import normalize_waveform as jnormalize
from aat_tpu.tokenizer import AdaptiveAudioTokenizer as JTok
from aat_tpu_torch.data import collate as tcollate
from aat_tpu_torch.runtime import host_ops
from aat_tpu_torch.tokenizer import AdaptiveAudioTokenizer as TTok
from tests.test_collate import WordTokenizer, make_item


def assert_batches_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        if w is None or isinstance(w, (int, np.integer)):
            assert got[k] == w, k
        else:
            assert got[k].dtype == w.dtype, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)


def corpus(seed, durations, n_words=12):
    rng = np.random.default_rng(seed)
    return [make_item(rng, d, n_words=n_words) for d in durations]


def both(segmentation, encoder="hubert", **kw):
    """(JAX collator, port collator) with the same settings."""
    make = lambda mod, tok: mod.TokenizedAudioWaveformCollator(  # noqa: E731
        audio_encoder_type=encoder, segmentation=segmentation,
        audio_tokenizer=tok.create(max_segment_duration_milliseconds=250),
        tokenizer=WordTokenizer(), uniform_segmentation_frames_per_segment=4000, **kw)
    return make(jcollate, JTok), make(tcollate, TTok)


CASES = {
    "uniform": ("uniform", dict(seed=0), (2.0, 1.5), 12),
    "adaptive-noise": ("adaptive", dict(seed=5, noise_augmentation=True), (2.0, 3.1, 1.2), 12),
    "uniform-n_words": ("uniform", dict(seed=3, n_words=6, add_prefix=False), (4.0, 5.5), 30),
    "adaptive-n_words-noise": ("adaptive", dict(seed=7, n_words=8, noise_augmentation=True),
                               (4.5, 6.0, 3.5), 30),
    "adaptive-unbucketed": ("adaptive", dict(seed=1, bucket_text=1, bucket_segments=1),
                            (2.5, 1.8), 12),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_collator_batches_equal_jax(case):
    segmentation, kw, durations, n_words = CASES[case]
    items = corpus(11, durations, n_words)
    jc, tc = both(segmentation, **kw)
    for is_validation in (False, False, True, False):
        want = jc(items, is_validation=is_validation)
        got = tc(items, is_validation=is_validation)
        assert_batches_equal(got, want)
    if "n_words" in kw:  # the crop happened: fewer words than the item has
        assert got["attention_mask"][0].sum() < n_words


@pytest.mark.parametrize("case", ["uniform", "adaptive-n_words-noise", "adaptive-unbucketed"])
def test_efficient_net_collator_batches_equal_jax(case):
    """The ``efficient_net`` branch: each segment's host melspec frames in
    ``[bs, segments, 64, 1 + 4000 // 160]``, zero-padded, and no waveform
    segments (``None``), element for element equal to JAX's."""
    segmentation, kw, durations, n_words = CASES[case]
    items = corpus(14, durations, n_words)
    jc, tc = both(segmentation, encoder="efficient_net", **kw)
    for is_validation in (False, True, False):
        want = jc(items, is_validation=is_validation)
        got = tc(items, is_validation=is_validation)
        assert_batches_equal(got, want)
    mels = got["batched_segments_melspectrograms"]
    assert mels.shape[0] == len(items) and mels.shape[2:] == (64, 26)
    assert got["batched_segments"] is None and got["segments_waveforms_mask"] is None
    pad = got["segments_boarders_attention_mask"] == 0
    assert pad.any() and not mels[pad].any()  # padded slots stay zero


@pytest.mark.parametrize("segmentation", ["uniform", "adaptive"])
def test_melspec_cache_is_read_memory_mapped_and_left_unwritten(tmp_path, segmentation):
    """A cached melspec (``<id>.npy``) is used as the computed one would be,
    and an unreadable cache entry is recomputed; the cache file is not
    written."""
    items = corpus(12, (4.0, 3.0, 2.2), n_words=30)
    tok = JTok.create(max_segment_duration_milliseconds=250)
    cached = tok.get_melspec(jnormalize(np.asarray(items[0]["audio"]["array"])))
    np.save(tmp_path / f"{items[0]['id']}.npy", cached)
    (tmp_path / f"{items[1]['id']}.npy").write_bytes(b"not an npy file")
    before = (tmp_path / f"{items[0]['id']}.npy").read_bytes()
    jc, tc = both(segmentation, seed=2, n_words=7, melspec_cache_dir=str(tmp_path))
    _, plain = both(segmentation, seed=2, n_words=7)
    for _ in range(2):
        want = jc(items)
        got = tc(items)
        assert_batches_equal(got, want)
        assert_batches_equal(plain(items), want)  # the cache equals the computation
    assert (tmp_path / f"{items[0]['id']}.npy").read_bytes() == before
    mel = tc._melspec_for(items[0], np.asarray(items[0]["audio"]["array"]))
    assert isinstance(mel, np.memmap) and not mel.flags.writeable


@pytest.mark.parametrize("noise,prefix", [(True, True), (False, True), (True, False)])
def test_no_segmentation_collator_equals_jax(noise, prefix):
    items = corpus(13, (1.0, 0.5, 0.8))
    jc = jcollate.NoSegmentationAudioWaveformCollator(
        WordTokenizer(), add_prefix=prefix, noise_augmentation=noise, seed=4)
    tc = tcollate.NoSegmentationAudioWaveformCollator(
        WordTokenizer(), add_prefix=prefix, noise_augmentation=noise, seed=4)
    for _ in range(3):
        assert_batches_equal(tc(items), jc(items))


def test_helpers_equal_jax():
    rng = np.random.default_rng(3)
    waves = [rng.normal(2.0, 3.0, 1000), rng.normal(-1.0, 0.5, 600)]
    for got, want in zip(tcollate.zero_mean_unit_var_pad(waves),
                         jcollate.zero_mean_unit_var_pad(waves)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(host_ops.normalize_pad(waves), jcollate.zero_mean_unit_var_pad(waves)):
        np.testing.assert_array_equal(got, want)
    got, want = tcollate.pad_waveforms(waves), jcollate.pad_waveforms(waves)
    assert_batches_equal(got, want)
    from aat_tpu.ops.segmentation import uniform_boundaries

    for n, f in ((16000, 4000), (17001, 4000), (100, 4000)):
        np.testing.assert_array_equal(tcollate.uniform_boundaries(n, f), uniform_boundaries(n, f))
    assert tcollate.PREFIXES == jcollate.PREFIXES


def test_assemble_segments_equals_jax_native_and_numpy_routes(monkeypatch):
    from aat_tpu.runtime import host_ops as jhost

    rng = np.random.default_rng(5)
    wave = rng.normal(0, 1, 9000).astype(np.float32)
    starts = np.array([0, 2500, 6000, 9000])
    ends = np.array([2500, 6000, 9000, 9000])
    lens = np.array([2500, 3500, 3000, 0])
    got = host_ops.assemble_segments(wave, starts, ends, lens, 4000)
    for route in ("native", "numpy"):
        if route == "numpy":
            monkeypatch.setattr(jhost, "load_library", lambda: None)
        for g, w in zip(got, jhost.assemble_segments(wave, starts, ends, lens, 4000)):
            np.testing.assert_array_equal(g, w)


def test_rejects_what_is_not_ported_or_wrong():
    with pytest.raises(ValueError, match="uniform or adaptive"):
        tcollate.TokenizedAudioWaveformCollator("efficient_net", "none", TTok(),
                                                WordTokenizer())
    _, tc = both("uniform")
    item = corpus(1, (1.0,))[0]
    item["audio"]["sampling_rate"] = 8000
    with pytest.raises(ValueError, match="sampling rate 8000"):
        tc([item])
