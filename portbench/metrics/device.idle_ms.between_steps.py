"""device.idle_ms.between_steps: idle device milliseconds a traced
training step, in gaps that began while no ``train.step`` span of the port
was open: the loop around the step and its wait for the data layer's
microbatches, where the profiler's window holds them (it starts at its
first recorded event) (``yardstick/spans.idle_by_phase``; layer: the
device). Moves ``train_audio_s_per_s``."""

from portbench.yardstick import spans

MOVES = "train_audio_s_per_s"


def read(obs):
    return spans.idle_ms_per_step(obs, "between_steps")
