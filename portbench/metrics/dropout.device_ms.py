"""dropout.device_ms: device milliseconds a training step spends in the
element dropout's hash and select (the port's ``ops.dropout`` span in
``ops/dropout.dropout``, the encoder's recompute included), read from
``span.ops.dropout.device_s`` over ``span.train.step.calls``, which exist
only for the steps the profiler recorded (layer: the kernels,
``ops/dropout``). Moves ``train_audio_s_per_s``."""

from portbench.yardstick import spans

MOVES = "train_audio_s_per_s"


def read(obs):
    return spans.device_ms_per_step("ops.dropout")
