"""layer_norm.device_ms: device milliseconds a training step spends in the
layer norm's kernels (``csrc/layer_norm.cu``: forward, backward and the sum
of the backward's partials; the encoder's recompute included): the
profiler's device time of the kernels whose names hold ``PATTERNS``, over
``span.train.step.calls``, which counts the steps the profiler recorded
(layer: the kernels, ``ops/layer_norm``). Moves ``train_audio_s_per_s``."""

from portbench.yardstick import spans, trace

MOVES = "train_audio_s_per_s"
PATTERNS = ("layer_norm_rows_", "layer_norm_cf_", "layer_norm_finish")


def read(obs):
    ops, table = obs.get("device_ops"), spans.port_counters()
    steps = table.get("span.train.step.calls") if table else None
    if not ops or not steps:
        return None
    seconds = trace.device_time_us(ops, PATTERNS) / 1e6
    return 1e3 * seconds / steps if seconds > 0 else None
