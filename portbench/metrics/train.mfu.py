"""train.mfu: the whole training step's share of the card's bf16 peak, in
%: model FLOPs of the window's steps (``yardstick/flops``: valid lengths,
causal attention at half, recompute not counted) over their wall time over
989 TFLOP/s, the steps of the profiler pass left out (layer: the trainer,
``training/trainer``, ``training/optim``, ``models/*``). Moves
``train_audio_s_per_s``."""

from portbench.yardstick import peaks

MOVES = "train_audio_s_per_s"


def read(obs):
    if obs.get("device_type") != "cuda" or not obs.get("model_flops") or not obs.get("model_s"):
        return None
    return 100.0 * obs["model_flops"] / obs["model_s"] / peaks.BF16_FLOPS
