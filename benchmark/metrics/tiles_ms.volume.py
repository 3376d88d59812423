"""Device milliseconds a ``predict_volume`` call in its batch loop
(gather, tile step, stitch: the port's ``volume.tiles`` span, timed by
CUDA events on the call's stream)."""

from benchmark import spans


def read(obs):
    return spans.per(obs, "volume", "calls", "volume.tiles", device=True)
