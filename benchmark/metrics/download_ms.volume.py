"""Host milliseconds a ``predict_volume`` call in its download: the port's
``volume.download`` spans, one a z slab of the result, each after
``volume.wait`` has waited for the slab's device-to-host copy into a
pinned slot: the host's copy of the slot into the fresh result array,
its page faults included.  They run beside the batch loop, but for the
slabs that its last batch completes, after it."""

from benchmark import spans


def read(obs):
    return spans.per(obs, "volume", "calls", "volume.download")
