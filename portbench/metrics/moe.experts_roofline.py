"""moe.experts_roofline: the held experts' grouped products' share of
their roofline, in %: 12 · ``moe.pairs_here`` · hidden · expert width
FLOPs (gate, up and down forward, and their input gradients) at the bf16
peak, or the held experts' weights read twice an expert layer call if that
takes longer, over the profiler's device time of the grouped GEMM kernels
(``torch._grouped_mm``'s CUTLASS kernels and their set-up) in the traced
steps. ``moe.pairs_here`` and ``span.moe.experts.calls`` exist only for the
steps the profiler recorded (layer: mixture of experts,
``models/deepseek_v2``). Moves ``train_audio_s_per_s``."""

from portbench.yardstick import peaks, spans, trace

MOVES = "train_audio_s_per_s"
PATTERNS = ("GroupProblemShape", "prepare_grouped_gemm_data")


def read(obs):
    table, moe, ops = spans.port_counters(), obs.get("moe"), obs.get("device_ops")
    if not table or not moe or not ops:
        return None
    pairs, calls = table.get("moe.pairs_here"), table.get("span.moe.experts.calls")
    seconds = trace.device_time_us(ops, PATTERNS) / 1e6
    if not pairs or not calls or seconds <= 0:
        return None
    h, w, held = moe["hidden"], moe["width"], moe["held"]
    flops_s = 12.0 * pairs * h * w / peaks.BF16_FLOPS
    bytes_s = calls * 2 * 3 * held * h * w * 2 / peaks.HBM_BYTES_PER_S
    return 100.0 * max(flops_s, bytes_s) / seconds
