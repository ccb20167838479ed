"""data.wait_ms: the time a training step waits for its microbatches, ms
per step, read on the host's clock around ``next()`` on the port's
``BatchIterator`` (layer: the data layer, ``data/collate`` and
``data/dataloaders``). Moves ``train_audio_s_per_s``."""

MOVES = "train_audio_s_per_s"


def read(obs):
    if "data_wait_s" not in obs or not obs.get("steps"):
        return None
    return 1e3 * obs["data_wait_s"] / obs["steps"]
