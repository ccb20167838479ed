"""mla.attention_ms: device milliseconds a training step spends in latent
attention (the port's ``mla.attention`` span: MLA's projections, the
latent norm, rotary and the (192, 128) flash forward, in the forward and
again where remat recomputes a layer in the backward; the kernels'
backward runs outside it, inside ``train.backward``), read from
``span.mla.attention.device_s`` over ``span.train.step.calls``, which
exist only for the steps the profiler recorded (layer: the kernels,
``models/deepseek_v2`` and ``ops/attention``). Moves
``train_audio_s_per_s``."""

from portbench.yardstick import spans

MOVES = "train_audio_s_per_s"


def read(obs):
    return spans.device_ms_per_step("mla.attention")
