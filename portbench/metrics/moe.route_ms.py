"""moe.route_ms: device milliseconds a training step spends routing (the
port's ``moe.route`` span: the router's product, softmax, top-k and the
permutation of the (token, choice) pairs by held expert, in the forward
and again where remat recomputes a layer in the backward), read from
``span.moe.route.device_s`` over ``span.train.step.calls``, which exist
only for the steps the profiler recorded (layer: mixture of experts,
``models/deepseek_v2``). Moves ``train_audio_s_per_s``."""

from portbench.yardstick import spans

MOVES = "train_audio_s_per_s"


def read(obs):
    return spans.device_ms_per_step("moe.route")
