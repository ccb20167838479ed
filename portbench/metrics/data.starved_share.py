"""data.starved_share: the share of the trainer's gets on the data layer's
prefetch queue that found it empty, in %: the port's ``data.empty_gets``
over ``data.gets``. The counters cover the whole run, set-up included; each
epoch starts a fresh queue (layer: the data layer). Moves
``train_audio_s_per_s``."""

from portbench.yardstick import spans

MOVES = "train_audio_s_per_s"


def read(obs):
    return spans.ratio("data.empty_gets", "data.gets", 100.0)
