"""The port's dataset utilities (``python -m aat_tpu_torch.scripts.<name>``)
against the JAX package's ``scripts/<name>.py`` run in-process (loaded
from its file, ``sys.argv`` set) on the same small ``datasets.Dataset``
written to disk: each saved output equal column by column (the
``melspec_precompute`` arrays bitwise), ``audio_tokenization`` on both
routes (the device route on the CPU here: the plain mel), the printed
statistics of ``dataset_info`` and ``inspect_embeddings`` equal, and
``parity_check`` passing with the same segment counts as JAX's, also with
``--encoder-check`` and with ``--weights`` / ``--lm-weights`` on tiny HF
directories (frames within 2e-4 of ``transformers``)."""

import contextlib
import importlib.util
import io
import os
import sys

import numpy as np
import pytest

datasets = pytest.importorskip("datasets")

from aat_tpu.utils import cache as jcache  # noqa: E402
from aat_tpu_torch.models import hubert as thub  # noqa: E402
from aat_tpu_torch.scripts import (audio_tokenization, dataset_info,  # noqa: E402
                                   inspect_embeddings, melspec_precompute, merge_datasets,
                                   parity_check, reduce_seq_len)
from tests.conftest import make_speechlike_waveform  # noqa: E402
from tests.test_torch_hf_readers import hubert_model, llama_model, save  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_jax(monkeypatch, name, argv):
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    return jax_script(name).main()


def corpus(path, seed=0, durations=(1.3, 2.1, 0.9, 1.7, 2.6)):
    rng = np.random.default_rng(seed)
    ds = datasets.Dataset.from_dict({
        "id": [f"utt{seed}-{i}" for i in range(len(durations))],
        "audio": [{"array": make_speechlike_waveform(rng, d), "sampling_rate": 16000}
                  for d in durations]})
    ds.save_to_disk(str(path))
    return str(path)


def assert_datasets_equal(got_dir, want_dir):
    got, want = datasets.load_from_disk(got_dir), datasets.load_from_disk(want_dir)
    assert got.column_names == want.column_names and len(got) == len(want)
    for column in want.column_names:
        assert got[column] == want[column], column


@pytest.fixture(autouse=True)
def no_jax_cache(monkeypatch):
    monkeypatch.setattr(jcache, "enable_compilation_cache", lambda *a, **k: None)


def test_melspec_precompute_equals_jax_bitwise(tmp_path, monkeypatch):
    data = corpus(tmp_path / "corpus.dataset")
    melspec_precompute.main(["--dataset", data, "--out", str(tmp_path / "port"), "--limit", "4"])
    run_jax(monkeypatch, "melspec_precompute",
            ["--dataset", data, "--out", str(tmp_path / "jax"), "--limit", "4"])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert len(names) == 4 and sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        got, want = np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=name)
    # an existing file is skipped, not rewritten
    stamp = os.path.getmtime(tmp_path / "port" / names[0])
    melspec_precompute.main(["--dataset", data, "--out", str(tmp_path / "port")])
    assert os.path.getmtime(tmp_path / "port" / names[0]) == stamp
    assert len(os.listdir(tmp_path / "port")) == 5


@pytest.mark.parametrize("route", ["host", "device-batch"])
def test_audio_tokenization_equals_jax(tmp_path, monkeypatch, route):
    data = corpus(tmp_path / "corpus.dataset", seed=1)
    extra = ["--device-batch", "2"] if route == "device-batch" else []
    audio_tokenization.main(["--dataset", data, "--out", str(tmp_path / "port.dataset"),
                             *extra], device="cpu")
    run_jax(monkeypatch, "audio_tokenization",
            ["--dataset", data, "--out", str(tmp_path / "jax.dataset"), *extra])
    assert_datasets_equal(str(tmp_path / "port.dataset"), str(tmp_path / "jax.dataset"))
    frames = datasets.load_from_disk(str(tmp_path / "port.dataset"))["segment_frames"]
    assert all(len(f) > 1 for f in frames)


def test_device_and_host_routes_split_a_near_tie_alike_in_both_packages(monkeypatch):
    """The device route's float32 mel and the host route's float64 mel can
    fall on either side of the 1e-5 minima comparator: on this seeded
    28.27 s utterance the device route finds one boundary more than the
    host route, in JAX as in the port (the device tables of the two
    packages equal). Not a kernel fault: the plain float32 route."""
    from aat_tpu.ops.mel import normalize_waveform as jnormalize
    from aat_tpu.tokenizer import AdaptiveAudioTokenizer as JTok

    rng = np.random.default_rng(5)
    waves = [make_speechlike_waveform(rng, d) for d in np.linspace(4.0, 30.0, 16).round(2)]
    wave = waves[14]
    tok = audio_tokenization.AdaptiveAudioTokenizer()
    host = audio_tokenization.segment_frames_host(tok, wave)
    device = audio_tokenization.segment_frames_batched(tok, [wave], "cpu")[0]
    w = jnormalize(np.asarray(wave))
    out = JTok().tokenize_batch(w[None].astype(np.float32), np.array([w.size], np.int32))
    jax_device = np.asarray(out["out_lens"])[0, : int(out["num_segments"][0])].tolist()
    assert jax_device == device and sum(device) == sum(host)
    assert len(device) == len(host) + 1


def test_reduce_seq_len_equals_jax(tmp_path, monkeypatch):
    data = corpus(tmp_path / "corpus.dataset", seed=2, durations=(1.0, 1.2, 0.8))
    rng = np.random.default_rng(5)
    aligned = datasets.Dataset.from_dict({
        "id": [f"utt2-{i}" for i in range(3)],
        "words": [[f"w{j}" for j in rng.integers(0, 9, 4)] for _ in range(3)],
        "word_start": [[0.0, 0.2, 0.4, 0.6]] * 3, "word_end": [[0.1, 0.3, 0.5, 0.7]] * 3})
    aligned_dir = str(tmp_path / "alignments")
    datasets.DatasetDict({"train": aligned}).save_to_disk(aligned_dir)
    reduce_seq_len.main(["--segments", data, "--alignments", aligned_dir,
                         "--out", str(tmp_path / "port.dataset")])
    # JAX streams its alignments from the hub: the same local items instead
    monkeypatch.setattr(datasets, "load_dataset",
                        lambda name, config, streaming: {"train": aligned})
    run_jax(monkeypatch, "reduce_seq_len", ["--segments", data, "--alignments", "hub/name",
                                            "--out", str(tmp_path / "jax.dataset")])
    assert_datasets_equal(str(tmp_path / "port.dataset"), str(tmp_path / "jax.dataset"))
    # items and alignments must agree id for id
    bad = datasets.Dataset.from_dict({**aligned.to_dict(), "id": ["x", "y", "z"]})
    bad.save_to_disk(str(tmp_path / "bad"))
    with pytest.raises(ValueError, match="meets alignment"):
        reduce_seq_len.main(["--segments", data, "--alignments", str(tmp_path / "bad"),
                             "--out", str(tmp_path / "never")])


def test_merge_datasets_equals_jax(tmp_path, monkeypatch):
    shards = [corpus(tmp_path / f"shard{i}.dataset", seed=10 + i, durations=(0.5, 0.7))
              for i in range(3)]
    merge_datasets.main(["--shards", *shards, "--out", str(tmp_path / "port.dataset")])
    run_jax(monkeypatch, "merge_datasets", ["--shards", *shards,
                                            "--out", str(tmp_path / "jax.dataset")])
    assert_datasets_equal(str(tmp_path / "port.dataset"), str(tmp_path / "jax.dataset"))
    assert len(datasets.load_from_disk(str(tmp_path / "port.dataset"))) == 6


def printed(fn):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn()
    return out.getvalue()


def test_dataset_info_and_inspect_embeddings_print_as_jax(tmp_path, monkeypatch):
    data = corpus(tmp_path / "corpus.dataset", seed=3)
    tokenized = str(tmp_path / "tokenized.dataset")
    audio_tokenization.main(["--dataset", data, "--out", tokenized], device="cpu")
    got = printed(lambda: dataset_info.main(["--dataset", tokenized]))
    want = printed(lambda: run_jax(monkeypatch, "dataset_info", ["--dataset", tokenized]))
    assert got == want and got.startswith("items: 5")

    rng = np.random.default_rng(6)
    emb = tmp_path / "embeddings"
    emb.mkdir()
    for i in range(4):
        np.save(emb / f"utt{i}.npy", rng.normal(0, 1, (3 + i, 8)).astype(np.float32))
    got = printed(lambda: inspect_embeddings.main(["--embeddings", str(emb), "--limit", "3"]))
    want = printed(lambda: run_jax(monkeypatch, "inspect_embeddings",
                                   ["--embeddings", str(emb), "--limit", "3"]))
    assert got == want and got.count("shape") == 3


def clip_lines(text):
    return [line.split(", mel")[0] for line in text.splitlines() if line.startswith("clip ")]


def test_parity_check_passes_with_jax_segment_counts(monkeypatch):
    argv = ["--clips", "3", "--seconds", "1.0"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert parity_check.main(argv + ["--cpu"]) == 0
    jout = io.StringIO()
    with contextlib.redirect_stdout(jout), pytest.raises(SystemExit) as exit_:
        run_jax(monkeypatch, "parity_check", argv)
    assert exit_.value.code == 0
    assert clip_lines(out.getvalue()) == clip_lines(jout.getvalue())
    assert len(clip_lines(out.getvalue())) == 3 and "PARITY: PASS" in out.getvalue()


def test_parity_check_with_weights_and_encoder_check(tmp_path, monkeypatch, capsys):
    """``--weights`` on a tiny ``HubertModel`` directory (read by the
    port's reader, held to ``transformers``' forward within 2e-4),
    ``--lm-weights`` on a tiny Llama directory (the eval wiring), and
    ``--encoder-check`` at the tiny width."""
    monkeypatch.setattr(thub, "hubert_large_config", thub.tiny_test_config)
    enc = save(hubert_model("HubertModel"), tmp_path / "hubert", "safetensors")
    lm = save(llama_model(tied=True), tmp_path / "lm", "safetensors")
    code = parity_check.main(["--clips", "1", "--seconds", "1.0", "--encoder-check",
                              "--weights", enc, "--lm-weights", lm, "--cpu"])
    text = capsys.readouterr().out
    assert code == 0, text
    frames = next(line for line in text.splitlines() if line.startswith("port parity"))
    assert float(frames.split("max |err| ")[1].split()[0]) < 2e-4 and "OK" in frames
    assert "pipeline segment means" in text and "eval wiring" in text
    assert "encoder bf16-vs-f32" in text and "PARITY: PASS" in text
