"""device.idle_ms.model: idle device milliseconds a traced training step,
in gaps that began inside the port's ``train.forward`` or
``train.backward`` span or a span inside them: launch gaps of the model
(``yardstick/spans.idle_by_phase``; layer: the device). Moves
``train_audio_s_per_s``."""

from portbench.yardstick import spans

MOVES = "train_audio_s_per_s"


def read(obs):
    return spans.idle_ms_per_step(obs, "model")
