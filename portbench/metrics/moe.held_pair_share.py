"""moe.held_pair_share: the share of the routed (token, choice) pairs that
fall on this chip's held experts, in %: ``moe.pairs_here`` over
``moe.pairs``, counted in the forward of the steps the profiler recorded
(layer: mixture of experts, ``models/deepseek_v2``). An even router reads
held over routed experts (8 of 64: 12.5%); more means more expert work a
token on this chip. Moves ``train_audio_s_per_s``."""

from portbench.yardstick import spans

MOVES = "train_audio_s_per_s"


def read(obs):
    return spans.ratio("moe.pairs_here", "moe.pairs", 100.0)
