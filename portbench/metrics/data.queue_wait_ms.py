"""data.queue_wait_ms: host milliseconds the trainer blocks on the data
layer's prefetch queue a microbatch: the port's ``data.wait_s`` (measured
around the get, where the wait happens) over ``data.gets``. The counters
cover the whole run, set-up included (layer: the data layer). Moves
``train_audio_s_per_s``."""

from portbench.yardstick import spans

MOVES = "train_audio_s_per_s"


def read(obs):
    return spans.ratio("data.wait_s", "data.gets", 1e3)
