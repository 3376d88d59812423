"""Host milliseconds a ``predict_volume`` call in its upload: the port's
``volume.upload`` spans, one a z slab of the host volume, each the host's
copy of the slab's planes into a pinned slot and the enqueue of its
host-to-device copy on the upload stream.  The first slab's comes before
the batch loop; the rest run beside it."""

from benchmark import spans


def read(obs):
    return spans.per(obs, "volume", "calls", "volume.upload")
