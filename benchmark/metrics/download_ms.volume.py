"""Host milliseconds a ``predict_volume`` call in its download: the port's
``volume.download`` span, after ``volume.wait`` has waited for the card
(the copy to pageable host memory, its page faults and ``.numpy()``)."""

from benchmark import spans


def read(obs):
    return spans.per(obs, "volume", "calls", "volume.download")
