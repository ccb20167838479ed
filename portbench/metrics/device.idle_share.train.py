"""device.idle_share.train: the share of the traced training steps' wall
in which no operation ran on the card, in %: one less the union of the
profiler's device intervals over the traced wall (layer: the device).
Moves ``train_audio_s_per_s``."""

MOVES = "train_audio_s_per_s"


def read(obs):
    busy, window = obs.get("busy_s"), obs.get("traced_window_s")
    if not busy or not window:
        return None
    return 100.0 * (1.0 - busy / window)
