"""``models/build.load_pretrained``: an ``AATTrainer.save_pretrained``
export rebuilt from its own ``config.json`` and ``params.pt`` in a fresh
process generates the same ids as the trainer that wrote it; an
adapter-only export loads with random frozen subtrees (with a warning) or,
with ``pretrained_missing``, with the subtrees read from the local
checkpoint directories the export records; it runs on the card unless
asked for the CPU. Mirrors ``tests/test_export.py:55, 107``."""

import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from aat_tpu_torch.models import build as tbuild
from aat_tpu_torch.training import checkpoint as ckpt
from aat_tpu_torch.training.config import TrainingConfig as TConfig
from aat_tpu_torch.training.generate import GenerationConfig
from aat_tpu_torch.training.trainer import AATTrainer
from aat_tpu_torch.utils import port as tport
from tests.test_torch_checkpoint import make_trainer
from tests.test_torch_hf_readers import hubert_model, llama_model, save
from tests._torch_trajectories import TRAIN, whole_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LOAD_AND_GENERATE = """
import sys
sys.path.insert(0, {repo!r})
import numpy as np
from aat_tpu_torch.models.build import load_pretrained
from aat_tpu_torch.training.config import TrainingConfig
from aat_tpu_torch.training.generate import GenerationConfig
from aat_tpu_torch.training.trainer import AATTrainer

model, params = load_pretrained({export!r}, device="cpu")
cfg = TrainingConfig(train_audio_encoder=True, train_lm_decoder=True, compute_dtype="float32",
                     output_dir={out!r})
trainer = AATTrainer(model, params, cfg, generation_config=GenerationConfig(num_beams=2))
batch = dict(np.load({batch!r}))
np.save({ids!r}, trainer.generate_for_batch(batch, max_new_tokens=8))
print(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "aat_tpu")))
"""


def prefixed(batch):
    bs = batch["input_ids"].shape[0]
    return {**batch, "prefix_input_ids": np.full((bs, 1), 1, np.int64),
            "prefix_attention_mask": np.ones((bs, 1), np.int64)}


def test_export_fresh_process_roundtrip(tmp_path):
    t = make_trainer(tmp_path, train_lm_decoder=True, learning_rate=1e-3)
    t.generation_config = GenerationConfig(num_beams=2)
    batch = prefixed(whole_batch(np.random.default_rng(3)))
    t.training_step([batch], fetch_metrics=False)  # the export differs from the init
    export = t.save_pretrained(str(tmp_path / "export"))
    with open(os.path.join(export, "config.json")) as f:
        desc = json.load(f)
    assert desc["model_type"] == "aslm"
    assert set(desc["saved_subtrees"]) == {"adapter", "audio_encoder", "lm_decoder"}
    want = t.generate_for_batch(batch, max_new_tokens=8)

    model, params = tbuild.load_pretrained(export, device="cpu")
    assert (model.config, model.audio_encoder_config, model.lm_config) == (
        t.model.config, t.model.audio_encoder_config, t.model.lm_config)
    saved = ckpt.flatten(t.state.params)
    got = ckpt.flatten(params)
    assert set(got) == set(saved) and all(torch.equal(got[k], v) for k, v in saved.items())

    np.savez(tmp_path / "batch.npz", **batch)
    script = LOAD_AND_GENERATE.format(repo=REPO, export=export, out=str(tmp_path / "run2"),
                                      batch=str(tmp_path / "batch.npz"),
                                      ids=str(tmp_path / "ids.npy"))
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=300, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"  # no JAX in that process
    np.testing.assert_array_equal(np.load(tmp_path / "ids.npy"), want)


def test_load_pretrained_partial_random_fallback(tmp_path, caplog):
    """An adapter-only export (frozen encoder and LM) loads with random
    frozen subtrees and says so."""
    t = make_trainer(tmp_path, train_audio_encoder=False, train_lm_decoder=False)
    t.training_step([whole_batch(np.random.default_rng(1))], fetch_metrics=False)
    export = t.save_pretrained(str(tmp_path / "export"))
    with caplog.at_level(logging.WARNING, logger="aat_tpu_torch.models.build"):
        model, params = tbuild.load_pretrained(export, seed=3, device="cpu")
    assert "lacks ['audio_encoder', 'lm_decoder']; using random init" in caplog.text
    assert set(params) == {"audio_encoder", "adapter", "lm_decoder"}
    for k, v in ckpt.flatten(t.state.params["adapter"]).items():
        assert torch.equal(ckpt.flatten(params["adapter"])[k], v), k
    assert model.lm_config == t.model.lm_config and model.config == t.model.config
    fresh = model.init_params(3)  # the random subtrees are the int-seed init
    for name in ("audio_encoder", "lm_decoder"):
        for k, v in ckpt.flatten(fresh[name]).items():
            assert torch.equal(ckpt.flatten(params[name])[k], v), k


def test_load_pretrained_reads_missing_subtrees_from_local_checkpoints(tmp_path):
    """``pretrained_missing``: the frozen LM the export left out is read
    from the LM directory its ``config.json`` records; the trained encoder
    and adapter come from the export."""
    enc = save(hubert_model("HubertForCTC"), tmp_path / "hubert", "safetensors")
    lm = save(llama_model(tied=True), tmp_path / "lm", "safetensors")
    cfg = TConfig(**dict(TRAIN, gradient_accumulation_steps=1, output_dir=str(tmp_path / "run"),
                         audio_encoder_checkpoint=enc, lm_pretrained_model=lm))
    model, params = tbuild.build_model(cfg, pretrained=True, device="cpu")
    t = AATTrainer(model, params, cfg)
    built = {k: v.clone() for k, v in ckpt.flatten(params["adapter"]).items()}
    t.training_step([whole_batch(np.random.default_rng(2))], fetch_metrics=False)
    export = t.save_pretrained(str(tmp_path / "export"))

    model2, params2 = tbuild.load_pretrained(export, pretrained_missing=True, device="cpu")
    assert model2.lm_config == model.lm_config
    want_lm = ckpt.flatten(tport.port_llama(lm)[0])
    for k, v in ckpt.flatten(params2["lm_decoder"]).items():
        assert torch.equal(v, want_lm[k]), k
    for name in ("audio_encoder", "adapter"):
        want = ckpt.flatten(t.state.params[name])
        assert all(torch.equal(v, want[k]) for k, v in ckpt.flatten(params2[name]).items())
    assert not all(torch.equal(v, built[k])  # the trained adapter, not the build's
                   for k, v in ckpt.flatten(params2["adapter"]).items())


def test_load_pretrained_runs_on_the_card_unless_asked(tmp_path, monkeypatch):
    export = make_trainer(tmp_path).save_pretrained(str(tmp_path / "export"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tbuild.load_pretrained(export)
    with pytest.raises(FileNotFoundError):
        tbuild.load_pretrained(str(tmp_path / "no-export"), device="cpu")
