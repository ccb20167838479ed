"""The train and validate command lines with ``--audio-encoder-type
efficient_net`` on the CPU (tiny LM, random b0, the dataset and tokenizer
seams of ``tests/test_torch_scripts.py``): the adaptive collator's melspec
batches train 2 steps with finite losses and moving BN running
statistics; the export's ``config.json`` records ``efficient_net`` and
reads back through ``load_pretrained`` bit for bit; ``validate`` evaluates
it on melspec batches."""

import json
import os

import numpy as np
import torch

from aat_tpu_torch.models import build as tbuild
from aat_tpu_torch.models.efficientnet import EfficientNetConfig
from aat_tpu_torch.scripts import train as ttrain
from aat_tpu_torch.scripts import validate as tvalidate
from aat_tpu_torch.training.checkpoint import flatten
from tests.test_torch_checkpoint import tiny_build
from tests.test_torch_scripts import losses, seams, speech_items, two_threads  # noqa: F401


def test_train_and_validate_cli_with_efficient_net(tmp_path, seams, monkeypatch):  # noqa: F811
    tiny_build(monkeypatch)
    seams(speech_items(3, [1.0, 1.3, 1.1, 1.4], n_words=8), speech_items(4, [0.9, 1.2]))
    trainer = ttrain.main(["--no-pretrained", "--audio-encoder-type", "efficient_net",
                           "--segmentation", "adaptive", "--compute-dtype", "float32",
                           "--per-device-train-batch-size", "2",
                           "--gradient-accumulation-steps", "1", "--num-train-epochs", "1",
                           "--logging-steps", "1", "--eval-steps", "0", "--save-steps", "0",
                           "--output-dir", str(tmp_path / "eff")], device="cpu")
    assert trainer.state.step == 2
    assert trainer.model.audio_encoder_type == "efficient_net"
    run_losses = losses(str(tmp_path / "eff_1_linear_adaptive"))
    assert len(run_losses) == 2 and all(np.isfinite(run_losses))
    stem = trainer.state.params["audio_encoder"]["stem"]["bn"]
    assert float(stem["mean"].abs().max()) > 0  # the running mean starts at 0

    path = trainer.save_pretrained(str(tmp_path / "export"))
    with open(os.path.join(path, "config.json")) as f:
        desc = json.load(f)
    assert desc["audio_encoder_type"] == "efficient_net"
    assert desc["audio_encoder_config"] == {"hidden_size": 1280, "in_channels": 3}
    model, params = tbuild.load_pretrained(path, device="cpu")
    assert isinstance(model.audio_encoder_config, EfficientNetConfig)
    for name in ("adapter", "audio_encoder"):
        want = flatten(trainer.state.params[name])
        for k, v in flatten(params[name]).items():
            assert torch.equal(v, want[k]), k

    metrics = tvalidate.main(["--checkpoint", path, "--items", "2", "--batch", "2",
                              "--no-pretrained"], device="cpu")
    assert np.isfinite(metrics["eval/loss"]) and "wer" in metrics
