"""train.optimizer_ms: device milliseconds a training step spends in the
optimizer (the port's ``train.optimizer`` span: the divide over
microbatches, ``tx.update``, ``apply_updates``, the BN fold), read from
``span.train.optimizer.device_s`` over ``span.train.step.calls``, which
exist only for the steps the profiler recorded (layer: the trainer,
``training/optim``). Moves ``train_audio_s_per_s``."""

from portbench.yardstick import spans

MOVES = "train_audio_s_per_s"


def read(obs):
    return spans.device_ms_per_step("train.optimizer")
