"""The port's command lines on the CPU, at tiny widths, with the two seams
a run on the card replaces too: ``load_hf_dataset`` (a small seeded
dataset stand-in) and ``build_tokenizer`` (the word-level tokenizer of
``tests/test_collate.py``), and tiny HF checkpoint directories for
``--pretrained``.

- ``scripts.train.build_config`` gives JAX's ``TrainingConfig`` for the
  same command line;
- the train CLI's per-step losses in ``metrics.jsonl`` equal those of JAX's
  ``scripts/train.py`` run on the same directories and data at
  ``--compute-dtype float32`` within 1e-5 (no eval, so both draw the
  collator's noise in the same order);
- a run resumed from ``checkpoint-6`` ends on the uninterrupted run's
  ``checkpoint-8`` bit for bit (params, moments, counts), with evals
  and prefixes on, and ``--no-load-best-model-at-end`` since neither
  package restores the best-metric record; without the checkpoint's
  collator state it does not;
- ``validate`` and ``serve --model-dir`` run on the export, serve's ids
  equal to ``serving.serve`` on the model it loads;
- every entry point defaults to the card, and ``build_tokenizer`` reads a
  local tokenizer (Qwen's BOS/EOS remap as in JAX) or raises."""

import dataclasses
import importlib.util
import json
import logging
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from aat_tpu.data import dataloaders as jdataloaders
from aat_tpu.models import build as jbuild
from aat_tpu.utils import cache as jcache
from aat_tpu_torch.data.collate import PREFIXES
from aat_tpu_torch.models import build as tbuild
from aat_tpu_torch.scripts import serve as tserve
from aat_tpu_torch.scripts import train as ttrain
from aat_tpu_torch.scripts import validate as tvalidate
from aat_tpu_torch.serving import serve as serving
from aat_tpu_torch.training.checkpoint import flatten as ckpt_flatten
from aat_tpu_torch.training.config import TrainingConfig as TConfig
from tests.conftest import make_speechlike_waveform
from tests.test_collate import WordTokenizer
from tests.test_torch_checkpoint import tiny_build
from tests.test_torch_hf_readers import hubert_model, llama_model, save
from tests._torch_threads import two_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = [f"w{i}" for i in range(24)]
LOSS_TOL = 1e-5


class Dataset(list):
    """A HF dataset stand-in: ``select``, ``shuffle(seed)``, ``len``."""

    def select(self, indices):
        return Dataset(self[int(i)] for i in indices)

    def shuffle(self, seed):
        return self.select(np.random.default_rng(seed).permutation(len(self)))


def speech_items(seed, durations, n_words=6):
    rng = np.random.default_rng(seed)
    out = Dataset()
    for i, d in enumerate(durations):
        starts = np.linspace(0, d * 0.9, n_words)
        out.append({"id": f"utt{seed}-{i}", "words": list(rng.choice(WORDS, n_words)),
                    "word_start": starts.tolist(), "word_end": (starts + d * 0.08).tolist(),
                    "audio": {"array": make_speechlike_waveform(rng, d), "sampling_rate": 16000}})
    return out


class FixedWords(WordTokenizer):
    """The word-level tokenizer with its whole vocabulary registered up
    front, so ids do not depend on which texts it saw first (a resumed run
    sees fewer)."""

    def __init__(self):
        super().__init__()
        for word in WORDS + " ".join(PREFIXES).split():
            self._id(word)


def datasets(train, valid):
    return lambda name, split=None: {"train": train, "valid": valid}[split]


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    """Tiny HuBERT (``HubertForCTC`` layout) and Llama (tied, GQA)
    directories."""
    root = tmp_path_factory.mktemp("hf")
    return (save(hubert_model("HubertForCTC"), root / "hubert", "safetensors"),
            save(llama_model(tied=True), root / "lm", "safetensors"))


@pytest.fixture
def seams(monkeypatch):
    """Replace the dataset and tokenizer seams of the port's scripts (and
    JAX's, for its run); returns a setter for the dataset."""
    monkeypatch.setenv("WANDB_MODE", "disabled")
    tokenizer = lambda config: FixedWords()  # noqa: E731

    def use(train, valid):
        for mod in (ttrain, tvalidate, jdataloaders):
            monkeypatch.setattr(mod, "load_hf_dataset", datasets(train, valid))
        for mod in (ttrain, tvalidate, jbuild):
            monkeypatch.setattr(mod, "build_tokenizer", tokenizer)

    return use


def jax_train_script():
    spec = importlib.util.spec_from_file_location("jax_train_script",
                                                  os.path.join(REPO, "scripts", "train.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def losses(output_dir):
    with open(os.path.join(output_dir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    return [line["train/loss"] for line in lines if "train/loss" in line]


BUILD_ARGS = {
    "default": [],
    "test-run": ["-t"],
    "finetune": ["-f", "--learning-rate", "3e-4"],
    "profile": ["-p", "--no-add-prefix"],
    "overrides": ["--max-steps", "8", "--n-words", "20", "--segmentation", "adaptive",
                  "--model-projection-from-pretrained", "/tmp/export", "--no-train-audio-encoder",
                  "--unfreeze-lm-at-epoch", "1", "--output-dir", "runs/x"],
}


@pytest.mark.parametrize("case", sorted(BUILD_ARGS))
def test_build_config_equals_jax(monkeypatch, case):
    argv = BUILD_ARGS[case]
    jscript = jax_train_script()
    monkeypatch.setattr(sys, "argv", ["train.py", *argv])
    want = jscript.build_config(jscript.parse_args())
    got = ttrain.build_config(ttrain.parse_args(argv))
    for field in dataclasses.fields(got):
        assert getattr(got, field.name) == getattr(want, field.name), field.name
        assert type(getattr(got, field.name)) is type(getattr(want, field.name)), field.name


def test_train_cli_losses_equal_jax(tmp_path, monkeypatch, seams, hf_dirs):
    """4 steps (2 epochs of 2 batches of 2), whole utterances of 0.5 s with
    6 words each (one compile on the JAX side), noise on, f32."""
    enc, lm = hf_dirs
    seams(speech_items(1, [0.5] * 4), speech_items(2, [0.5] * 2))
    monkeypatch.setattr(jcache, "enable_compilation_cache", lambda *a, **k: None)
    argv = ["--pretrained", "--audio-encoder-checkpoint", enc, "--lm-pretrained-model", lm,
            "--compute-dtype", "float32", "--per-device-train-batch-size", "2",
            "--gradient-accumulation-steps", "1", "--num-train-epochs", "2",
            "--logging-steps", "1", "--eval-steps", "0", "--save-steps", "0",
            "--no-load-best-model-at-end", "--no-add-prefix"]
    ttrain.main(argv + ["--output-dir", str(tmp_path / "port")], device="cpu")
    monkeypatch.setattr(sys, "argv", ["train.py", *argv, "--output-dir", str(tmp_path / "jax")])
    jax_train_script().main()
    got, want = (losses(str(tmp_path / f"{name}_1_linear_none")) for name in ("port", "jax"))
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, atol=LOSS_TOL, rtol=0)


def read_checkpoint(path):
    return {name: torch.load(os.path.join(path, f"{name}.pt"), weights_only=True)
            for name in ("params", "optimizer")}


def flat_tensors(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_tensors(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree if torch.is_tensor(tree) else torch.tensor(tree)}


def equal_checkpoints(a, b):
    fa, fb = flat_tensors(read_checkpoint(a)), flat_tensors(read_checkpoint(b))
    assert set(fa) == set(fb) and len(fa) > 40
    return [k for k in fa if not torch.equal(fa[k], fb[k])]


@pytest.mark.parametrize("resume_step", [6, 4])
def test_train_cli_resume_equals_uninterrupted_run(tmp_path, seams, hf_dirs, caplog,
                                                   resume_step):
    """Resumed mid-epoch (step 6 of 8: epoch 1, 2 batches fast-forwarded;
    saves every 3 steps) or at an epoch's end (step 4: epoch 1 from its
    start; saves every 4 steps)."""
    enc, lm = hf_dirs
    seams(speech_items(3, [0.4, 0.55, 0.45, 0.65, 0.5, 0.6, 0.35, 0.7]),
          speech_items(4, [0.45, 0.6, 0.5, 0.4]))
    every = {6: "3", 4: "4"}[resume_step]
    argv = ["--pretrained", "--audio-encoder-checkpoint", enc, "--lm-pretrained-model", lm,
            "--per-device-train-batch-size", "2", "--gradient-accumulation-steps", "1",
            "--num-train-epochs", "2", "--eval-steps", every, "--save-steps", every,
            "--logging-steps", "1", "--no-load-best-model-at-end", "--compute-dtype", "float32"]
    a = str(tmp_path / "a")
    trainer = ttrain.main(argv + ["--output-dir", a], device="cpu")
    out_a = a + "_1_linear_none"
    ckpts = sorted(d for d in os.listdir(out_a) if d.startswith("checkpoint-"))
    assert {f"checkpoint-{resume_step}", "checkpoint-8"} <= set(ckpts)
    with open(os.path.join(out_a, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert sum("eval/loss" in line for line in lines) == 8 // int(every)
    assert len(losses(out_a)) == 8 and trainer.state.step == 8
    resume = os.path.join(out_a, f"checkpoint-{resume_step}")
    with open(os.path.join(resume, ttrain.DATA_STATE_FILE)) as f:
        assert json.load(f)["epoch"] == 1

    ttrain.main(argv + ["--output-dir", str(tmp_path / "b"), "--resume-from-checkpoint",
                        resume], device="cpu")
    out_b = str(tmp_path / "b") + "_1_linear_none"
    assert equal_checkpoints(os.path.join(out_a, "checkpoint-8"),
                             os.path.join(out_b, "checkpoint-8")) == []
    assert losses(out_b) == losses(out_a)[resume_step:]
    if resume_step != 6:
        return

    # without the collator state the resumed run draws other noise and
    # prefixes, and ends elsewhere
    bare = str(tmp_path / "bare-checkpoint-6")
    shutil.copytree(resume, bare)
    os.remove(os.path.join(bare, ttrain.DATA_STATE_FILE))
    with caplog.at_level(logging.WARNING, logger="aat_tpu_torch.scripts.train"):
        ttrain.main(argv + ["--output-dir", str(tmp_path / "c"), "--resume-from-checkpoint",
                            bare], device="cpu")
    assert "no collator state for epoch 1" in caplog.text
    assert equal_checkpoints(os.path.join(out_a, "checkpoint-8"),
                             str(tmp_path / "c") + "_1_linear_none/checkpoint-8")


def test_train_cli_refuses_what_needs_unfreezing(tmp_path, monkeypatch, seams, hf_dirs):
    """``--unfreeze-lm-at-epoch 1`` (which the port once refused): the LM
    stays bitwise frozen through epoch 0 and trains in epoch 1, and the 4
    losses equal those of JAX's ``scripts/train.py`` on the same command
    line within 1e-5 (f32, whole utterances, no eval)."""
    enc, lm = hf_dirs
    seams(speech_items(5, [0.5] * 4), speech_items(6, [0.5] * 2))
    monkeypatch.setattr(jcache, "enable_compilation_cache", lambda *a, **k: None)
    argv = ["--pretrained", "--audio-encoder-checkpoint", enc, "--lm-pretrained-model", lm,
            "--compute-dtype", "float32", "--per-device-train-batch-size", "2",
            "--gradient-accumulation-steps", "1", "--num-train-epochs", "2",
            "--unfreeze-lm-at-epoch", "1", "--logging-steps", "1", "--eval-steps", "0",
            "--save-steps", "2", "--no-load-best-model-at-end", "--no-add-prefix"]
    trainer = ttrain.main(argv + ["--output-dir", str(tmp_path / "port")], device="cpu")
    monkeypatch.setattr(sys, "argv", ["train.py", *argv, "--output-dir", str(tmp_path / "jax")])
    jax_train_script().main()
    got, want = (losses(str(tmp_path / f"{name}_1_linear_none")) for name in ("port", "jax"))
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, atol=LOSS_TOL, rtol=0)

    out = str(tmp_path / "port") + "_1_linear_none"
    lm_at = {step: read_checkpoint(os.path.join(out, f"checkpoint-{step}"))["params"]["params"]
             for step in (2, 4)}
    initial, _ = tbuild.build_lm_decoder(TConfig(lm_pretrained_model=lm), device="cpu")
    lm_keys = [k for k in lm_at[2] if k.startswith("lm_decoder.")]
    assert lm_keys and trainer.config.train_lm_decoder
    for k in lm_keys:  # epoch 0 (steps 1-2): bitwise the read weights
        assert torch.equal(lm_at[2][k], ckpt_flatten(initial)[k[len("lm_decoder."):]]), k
    final = ckpt_flatten(trainer.state.params["lm_decoder"])
    assert any(not torch.equal(final[k[len("lm_decoder."):]], lm_at[2][k]) for k in lm_keys)
    assert json.load(open(os.path.join(out, "checkpoint-2", "trainer_meta.json")))[
        "train_lm_decoder"] is False


def test_train_cli_resumes_a_run_that_unfroze_the_lm(tmp_path, seams, hf_dirs, caplog):
    """A run resumed from a checkpoint taken after the unfreeze (step 6 of
    8, epoch 1) unfreezes before restoring, so the LM's moments restore
    too, and ends on the uninterrupted run's ``checkpoint-8`` bit for
    bit."""
    enc, lm = hf_dirs
    seams(speech_items(15, [0.4, 0.55, 0.45, 0.65, 0.5, 0.6, 0.35, 0.7]),
          speech_items(16, [0.45, 0.6]))
    argv = ["--pretrained", "--audio-encoder-checkpoint", enc, "--lm-pretrained-model", lm,
            "--per-device-train-batch-size", "2", "--gradient-accumulation-steps", "1",
            "--num-train-epochs", "2", "--unfreeze-lm-at-epoch", "1", "--eval-steps", "0",
            "--save-steps", "3", "--logging-steps", "1", "--no-load-best-model-at-end",
            "--compute-dtype", "float32"]
    a = str(tmp_path / "a")
    ttrain.main(argv + ["--output-dir", a], device="cpu")
    out_a = a + "_1_linear_none"
    resume = os.path.join(out_a, "checkpoint-6")
    meta = json.load(open(os.path.join(resume, "trainer_meta.json")))
    assert meta["train_lm_decoder"] is True
    saved_opt = read_checkpoint(resume)["optimizer"]
    assert any(k.startswith("mu.lm_decoder.") for k in saved_opt)
    with caplog.at_level(logging.WARNING):
        trainer = ttrain.main(argv + ["--output-dir", str(tmp_path / "b"),
                                      "--resume-from-checkpoint", resume], device="cpu")
    assert "not restorable" not in caplog.text
    assert trainer.config.train_lm_decoder and trainer.state.step == 8
    out_b = str(tmp_path / "b") + "_1_linear_none"
    assert equal_checkpoints(os.path.join(out_a, "checkpoint-8"),
                             os.path.join(out_b, "checkpoint-8")) == []
    assert losses(out_b) == losses(out_a)[6:]


def test_train_cli_profile_writes_a_cprofile_dump(tmp_path, seams, hf_dirs, monkeypatch):
    """``-p``: the overfit preset, run under cProfile, whose stats land in
    ``train_profile.prof`` in the working directory."""
    import pstats

    enc, lm = hf_dirs
    seams(speech_items(9, [0.4] * 4), speech_items(10, [0.4] * 2))
    monkeypatch.chdir(tmp_path)
    trainer = ttrain.main(["-p", "--audio-encoder-checkpoint", enc, "--lm-pretrained-model", lm,
                           "--few-train-samples", "2", "--per-device-train-batch-size", "2",
                           "--num-train-epochs", "1", "--eval-steps", "0", "--save-steps", "0",
                           "--compute-dtype", "float32", "--output-dir", str(tmp_path / "p")],
                          device="cpu")
    assert trainer.state.step == 1 and trainer.config.n_words == 50
    stats = pstats.Stats(str(tmp_path / "train_profile.prof"))
    assert any(func[2] == "training_step" for func in stats.stats)


@pytest.fixture
def export(tmp_path, seams, monkeypatch, hf_dirs):
    """A ``save_pretrained`` export of a 2-step adaptive-segmentation run
    (the ``n_words`` crop on), and the tiny full-size stand-ins for
    ``--no-pretrained``."""
    enc, lm = hf_dirs
    seams(speech_items(7, [1.0, 1.3, 1.1, 1.4], n_words=12), speech_items(8, [0.9, 1.2, 0.8]))
    trainer = ttrain.main(["--audio-encoder-checkpoint", enc, "--lm-pretrained-model", lm,
                           "--segmentation", "adaptive", "--n-words", "8",
                           "--per-device-train-batch-size", "2",
                           "--gradient-accumulation-steps", "1", "--num-train-epochs", "1",
                           "--logging-steps", "1", "--eval-steps", "0", "--save-steps", "0",
                           "--output-dir", str(tmp_path / "seg")], device="cpu")
    assert trainer.state.step == 2
    assert all(np.isfinite(losses(str(tmp_path / "seg_1_linear_adaptive"))))
    tiny_build(monkeypatch)
    return trainer.save_pretrained(str(tmp_path / "export"))


def test_validate_runs_on_the_export(export, capsys):
    metrics = tvalidate.main(["--checkpoint", export, "--items", "3", "--batch", "2",
                              "--no-pretrained"], device="cpu")
    assert np.isfinite(metrics["eval/loss"])
    assert {"wer", "evaluate_bleu", "evaluate_meteor"} <= set(metrics)
    assert str(metrics) in capsys.readouterr().out


def test_serve_model_dir_equals_the_loaded_model(export, capsys):
    argv = ["--model-dir", export, "--random-demo", "3", "--max-new-tokens", "8",
            "--max-slots", "2", "--max-segments", "16"]
    assert tserve.main(argv, device="cpu") == 0
    captured = capsys.readouterr()
    assert "tokenizer unavailable" in captured.err
    lines = [json.loads(line) for line in captured.out.strip().splitlines()]
    assert [line["audio"] for line in lines] == ["demo-0", "demo-1", "demo-2"]
    model, params = tbuild.load_pretrained(export, device="cpu")
    want = serving.serve(model, params, tserve.demo_waves(3),
                         tserve.serve_config(tserve.parse_args(argv), 2))
    for line, ids in zip(lines, want):
        assert line["ids"] == ids.tolist() and len(ids) == 8


@pytest.mark.parametrize("entry", ["train", "validate", "serve"])
def test_entry_points_default_to_the_card(monkeypatch, tmp_path, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    run = {"train": lambda: ttrain.main(["--no-pretrained", "--output-dir", str(tmp_path)]),
           "validate": lambda: tvalidate.main(["--checkpoint", str(tmp_path), "--no-pretrained"]),
           "serve": lambda: tserve.main(["--model-dir", str(tmp_path), "--random-demo", "1"])}
    if entry == "serve":
        export = save_tiny_export(tmp_path)
        run["serve"] = lambda: tserve.main(["--model-dir", export, "--random-demo", "1"])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        run[entry]()


def save_tiny_export(tmp_path):
    from tests.test_torch_checkpoint import make_trainer

    return make_trainer(tmp_path).save_pretrained(str(tmp_path / "export"))


def word_tokenizer_dir(path, name="tokenizer"):
    """A tiny word-level HF tokenizer saved under ``path / name``."""
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace
    from transformers import PreTrainedTokenizerFast

    vocab = {t: i for i, t in enumerate(
        ["<pad>", "<s>", "</s>", "<unk>", "<|im_start|>", "<|im_end|>", *WORDS])}
    tok = Tokenizer(WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = Whitespace()
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, bos_token="<s>", eos_token="</s>",
                                   pad_token="<pad>", unk_token="<unk>",
                                   additional_special_tokens=["<|im_start|>", "<|im_end|>"])
    fast.save_pretrained(str(path / name))
    return str(path / name)


@pytest.mark.parametrize("name", ["tiny-smollm", "tiny-qwen"])
def test_build_tokenizer_equals_jax(tmp_path, name):
    path = word_tokenizer_dir(tmp_path, name)
    got = tbuild.build_tokenizer(TConfig(lm_pretrained_model=path))
    want = jbuild.build_tokenizer(TConfig(lm_pretrained_model=path))
    assert (got.bos_token_id, got.eos_token_id) == (want.bos_token_id, want.eos_token_id)
    assert (got.bos_token_id, got.eos_token_id) == ((4, 5) if "qwen" in name else (1, 2))
    assert got("w1 w2")["input_ids"] == want("w1 w2")["input_ids"]


def test_build_tokenizer_needs_transformers_and_a_local_dir(monkeypatch, tmp_path):
    with pytest.raises(FileNotFoundError, match="local checkpoint directory"):
        tbuild.build_tokenizer(TConfig())
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(RuntimeError, match="`transformers` package"):
        tbuild.build_tokenizer(TConfig(lm_pretrained_model=str(tmp_path)))
