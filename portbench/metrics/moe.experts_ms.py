"""moe.experts_ms: device milliseconds a training step spends in the held
experts (the port's ``moe.experts`` span: the grouped gate, up and down
products and the weighted combine, in the forward and again where remat
recomputes a layer in the backward; their backward runs outside it, inside
``train.backward``), read from ``span.moe.experts.device_s`` over
``span.train.step.calls``, which exist only for the steps the profiler
recorded (layer: mixture of experts, ``models/deepseek_v2``). Moves
``train_audio_s_per_s``."""

from portbench.yardstick import spans

MOVES = "train_audio_s_per_s"


def read(obs):
    return spans.device_ms_per_step("moe.experts")
