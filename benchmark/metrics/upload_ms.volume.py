"""Host milliseconds a ``predict_volume`` call in its upload: the port's
``volume.upload`` span, the blocking copy of the host volume to the card
from pageable memory."""

from benchmark import spans


def read(obs):
    return spans.per(obs, "volume", "calls", "volume.upload")
