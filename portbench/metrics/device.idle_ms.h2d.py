"""device.idle_ms.h2d: idle device milliseconds a traced training step,
in gaps that began while the port's ``train.h2d`` span (the microbatch's
copy to the card, ``AATTrainer._to_device``) was the innermost span open
on the host (``yardstick/spans.idle_by_phase``; layer: the device). Moves
``train_audio_s_per_s``."""

from portbench.yardstick import spans

MOVES = "train_audio_s_per_s"


def read(obs):
    return spans.idle_ms_per_step(obs, "h2d")
