"""The offline discrete-token pipeline end to end, the port against the
JAX package at tiny widths: per-segment HuBERT frame embeddings
(``aat_tpu_torch.scripts.segment_embeddings``, with the encoder's random
weights carried across) against the JAX script's body (normalize →
``tokenize`` → dense segment batch → ``hubert_encode``) within 2e-4; mean
pooling (``scripts/mean_segment_embeddings.py``) equal; and token ids and
codebook (``scripts/quantize_embeddings.py``) from the two pipelines'
outputs. The JAX scripts run as subprocesses on the CPU; the JAX
segment-embedding script itself needs ``datasets`` and a pretrained
checkpoint, so its per-utterance body is run here in-process."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from aat_tpu.audio import AudioWaveform as JWave
from aat_tpu.models import build as jbuild
from aat_tpu.models import hubert as jhub
from aat_tpu.ops.mel import normalize_waveform as jnormalize
from aat_tpu.tokenizer import AdaptiveAudioTokenizer as JTok
from aat_tpu.training.config import TrainingConfig as JConfig
from aat_tpu_torch.models import hubert as thub
from aat_tpu_torch.scripts import mean_segment_embeddings as tmean
from aat_tpu_torch.scripts import quantize_embeddings as tquant
from aat_tpu_torch.scripts import segment_embeddings as tsegemb
from tests._torch_threads import two_threads  # noqa: F401
from tests.conftest import make_speechlike_waveform
from tests.test_torch_vq import assert_ids_agree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DURATIONS = (2.5, 4.0, 3.2)


class Items(list):
    """A dataset stand-in: items with an id and an audio array."""

    def select(self, indices):
        return Items(self[i] for i in indices)


def corpus():
    return Items({"id": f"utt{i}", "audio": {"array": make_speechlike_waveform(
        np.random.default_rng(20 + i), d)}} for i, d in enumerate(DURATIONS))


def jax_segment_embeddings(items, out_dir, encoder=None):
    """The JAX script's per-utterance body (scripts/segment_embeddings.py)
    with ``build_audio_encoder(pretrained=False)``, or reading the local
    checkpoint directory ``encoder``."""
    if encoder is None:
        params, cfg = jbuild.build_audio_encoder(JConfig(), pretrained=False)
    else:
        params, cfg = jbuild.build_audio_encoder(JConfig(audio_encoder_checkpoint=encoder),
                                                 pretrained=True)
    params = jax.device_put(params)

    @jax.jit
    def encode(waveforms, mask):
        return jhub.hubert_encode(params, cfg, waveforms, mask)

    tok = JTok()
    os.makedirs(out_dir)
    for item in items:
        wave = jnormalize(np.asarray(item["audio"]["array"]))
        segments, _ = tok.tokenize(JWave(wave, 16000))
        batch = np.zeros((len(segments), tok.max_segment_frames), np.float32)
        mask = np.zeros(batch.shape, np.int32)
        for i, seg in enumerate(segments):
            batch[i, : seg.waveform.shape[-1]] = seg.waveform
            mask[i, : seg.waveform.shape[-1]] = 1
        frames, frame_mask = encode(jnp.asarray(batch), jnp.asarray(mask))
        frames, frame_mask = np.asarray(frames), np.asarray(frame_mask)
        np.savez(os.path.join(out_dir, item["id"] + ".npz"),
                 **{f"segment_{i}": frames[i, frame_mask[i].astype(bool)]
                    for i in range(len(segments))})


def run_jax_script(name, args, tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu", AAT_TPU_CACHE_DIR=str(tmp_path / "cache"))
    proc = subprocess.run([sys.executable, os.path.join(REPO, "scripts", name), *args],
                          env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.fixture
def tiny_encoders(monkeypatch):
    """hubert-large swapped for the tiny config in both packages; the port
    takes its flash route (on the CPU the kernel's plain version), JAX its
    XLA route."""
    monkeypatch.setattr(jhub, "hubert_large_config", jhub.tiny_test_config)
    monkeypatch.setattr(thub, "hubert_large_config", lambda: dataclasses.replace(
        thub.tiny_test_config(), attention_impl="pallas"))


def test_pipeline_matches_jax(tmp_path, monkeypatch, tiny_encoders):
    items = corpus()
    monkeypatch.setattr(tsegemb, "load_hf_dataset", lambda name, split=None: items)
    port_seg, jax_seg = tmp_path / "port_seg", tmp_path / "jax_seg"
    tsegemb.main(["--dataset", "corpus", "--out", str(port_seg), "--random-init"],
                 device="cpu")
    jax_segment_embeddings(items, str(jax_seg))

    # 1. frame embeddings per segment
    n_segments = 0
    for item in items:
        got = np.load(port_seg / (item["id"] + ".npz"))
        want = np.load(jax_seg / (item["id"] + ".npz"))
        assert sorted(got.files) == sorted(want.files)
        n_segments += len(got.files)
        for key in want.files:
            assert got[key].shape == want[key].shape and got[key].shape[0] > 0, key
            np.testing.assert_allclose(got[key], want[key], atol=2e-4, rtol=0, err_msg=key)
    assert n_segments > len(items)  # the tokenizer split every utterance

    # 2. mean pooling: the port's CLI and the JAX script on the same files
    tmean.main(["--embeddings", str(jax_seg), "--out", str(tmp_path / "port_mean")])
    run_jax_script("mean_segment_embeddings.py",
                   ["--embeddings", str(jax_seg), "--out", str(tmp_path / "jax_mean")], tmp_path)
    for item in items:
        got = np.load(tmp_path / "port_mean" / (item["id"] + ".npy"))
        want = np.load(tmp_path / "jax_mean" / (item["id"] + ".npy"))
        assert got.shape == want.shape and got.shape[0] == 1
        np.testing.assert_array_equal(got, want)

    # 3. ids: the port's whole pipeline against the JAX one, end to end
    tmean.main(["--embeddings", str(port_seg), "--out", str(tmp_path / "port_mean2")])
    codes = n_segments // 2
    args = ["--codes", str(codes), "--iters", "10"]
    tquant.main(["--embeddings", str(tmp_path / "port_mean2"), "--out",
                 str(tmp_path / "port_tok"), *args], device="cpu")
    run_jax_script("quantize_embeddings.py", ["--embeddings", str(tmp_path / "jax_mean"),
                                              "--out", str(tmp_path / "jax_tok"), *args],
                   tmp_path)
    want_cb = np.load(tmp_path / "jax_tok" / "codebook.npy")
    np.testing.assert_allclose(np.load(tmp_path / "port_tok" / "codebook.npy"), want_cb,
                               atol=1e-4, rtol=0)
    for item in items:
        got = np.load(tmp_path / "port_tok" / (item["id"] + ".tokens.npy"))
        want = np.load(tmp_path / "jax_tok" / (item["id"] + ".tokens.npy"))
        assert got.dtype == np.int32 and got.shape == want.shape
        x = np.load(tmp_path / "jax_mean" / (item["id"] + ".npy"))[0]
        assert_ids_agree(got, want, x, want_cb)


def test_segment_embeddings_needs_a_gpu_by_default(monkeypatch, tiny_encoders):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsegemb.main(["--dataset", "corpus", "--random-init"])


def test_pretrained_encoder_is_not_ported_yet(monkeypatch, tmp_path):
    """``--pretrained`` (the default) reads the encoder from the local HF
    directory ``--encoder``: the embeddings equal the JAX script body's on
    the same directory within 2e-4; a hub name with no local directory
    raises ``FileNotFoundError``."""
    from tests.test_torch_hf_readers import hubert_model, save

    items = corpus()
    monkeypatch.setattr(tsegemb, "load_hf_dataset", lambda name, split=None: items)
    with pytest.raises(FileNotFoundError, match="local checkpoint directory"):
        tsegemb.main(["--dataset", "corpus", "--out", str(tmp_path / "none")], device="cpu")
    encoder = save(hubert_model("HubertForCTC"), tmp_path / "hubert", "safetensors")
    tsegemb.main(["--dataset", "corpus", "--out", str(tmp_path / "port"), "--encoder", encoder],
                 device="cpu")
    jax_segment_embeddings(items, str(tmp_path / "jax"), encoder=encoder)
    for item in items:
        got = np.load(tmp_path / "port" / (item["id"] + ".npz"))
        want = np.load(tmp_path / "jax" / (item["id"] + ".npz"))
        assert sorted(got.files) == sorted(want.files) and len(want.files) > 1
        for key in want.files:
            assert got[key].shape == want[key].shape, key
            np.testing.assert_allclose(got[key], want[key], atol=2e-4, rtol=0, err_msg=key)
