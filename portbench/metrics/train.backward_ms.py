"""train.backward_ms: device milliseconds a training step spends in the
backward (the port's ``train.backward`` span: ``torch.autograd.grad`` of
each microbatch, the encoder's recompute included under remat), read from
``span.train.backward.device_s`` over ``span.train.step.calls``, which
exist only for the steps the profiler recorded (layer: the trainer).
Moves ``train_audio_s_per_s``."""

from portbench.yardstick import spans

MOVES = "train_audio_s_per_s"


def read(obs):
    return spans.device_ms_per_step("train.backward")
