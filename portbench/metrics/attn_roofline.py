"""attn_roofline: the flash attention kernels' share of their roofline, in
%: the least time of every flash launch of the traced steps
(``yardstick/bounds.attention_seconds`` from the shapes and key masks the
launches were given) over the profiler's device time of the kernels whose
names hold ``PATTERNS`` (layer: the kernels, ``ops/attention`` and
``csrc/flash_*``). Moves ``train_audio_s_per_s``."""

from portbench.yardstick import trace

MOVES = "train_audio_s_per_s"
PATTERNS = ("flash_fwd", "flash_bwd")


def read(obs):
    bound, ops = obs.get("attention_bound_s"), obs.get("device_ops")
    if not bound or not ops:
        return None
    seconds = trace.device_time_us(ops, PATTERNS) / 1e6
    return 100.0 * bound / seconds if seconds > 0 else None
