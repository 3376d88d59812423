"""Host milliseconds a train step in making batches: the port's
``data.batch`` spans of both datasets (the host gather, pinning, issuing the
H2D copy and the transforms' launches), on the host clock."""

from benchmark import spans


def read(obs):
    return spans.per(obs, "train", "steps", "data.batch")
