"""data.collate_ms: host milliseconds the data layer takes to collate one
microbatch (``BatchIterator``'s prefetch thread running
``NoSegmentationAudioWaveformCollator``): the port's ``data.collate_s``
over ``data.batches``. The counters cover the whole run, set-up included
(layer: the data layer). Moves ``train_audio_s_per_s``."""

from portbench.yardstick import spans

MOVES = "train_audio_s_per_s"


def read(obs):
    return spans.ratio("data.collate_s", "data.batches", 1e3)
