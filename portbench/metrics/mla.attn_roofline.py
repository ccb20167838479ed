"""mla.attn_roofline: the latent-attention flash kernels' share of their
roofline, in %: the least time of every flash launch of the traced steps
whose q and k are wider than its v (``yardstick/bounds_mla``, from the
shapes and key masks the launches were given) over the profiler's device
time of the kernels built for those widths, ``<192, 128, ...>``, and the
backward's rowsum of their 128-wide rows (layer: the kernels,
``ops/attention`` and ``csrc/flash_*_mma.cu``). Moves
``train_audio_s_per_s``."""

from portbench.yardstick import trace

MOVES = "train_audio_s_per_s"
PATTERNS = ("<192, 128", "flash_bwd_delta_kernel<128>")


def read(obs):
    bound, ops = obs.get("mla_bound_s"), obs.get("device_ops")
    if not bound or not ops:
        return None
    seconds = trace.device_time_us(ops, PATTERNS) / 1e6
    return 100.0 * bound / seconds if seconds > 0 else None
