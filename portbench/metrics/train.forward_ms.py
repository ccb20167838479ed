"""train.forward_ms: device milliseconds a training step spends in the
forward (the port's ``train.forward`` span: ``_assemble_and_forward`` and
the caption cross-entropy of each microbatch), read from the port's
``span.train.forward.device_s`` over ``span.train.step.calls``. Both exist
only for the steps the profiler recorded (layer: the trainer,
``models/*``). Moves ``train_audio_s_per_s``."""

from portbench.yardstick import spans

MOVES = "train_audio_s_per_s"


def read(obs):
    return spans.device_ms_per_step("train.forward")
