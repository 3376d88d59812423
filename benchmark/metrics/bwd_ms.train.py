"""Device milliseconds a train step in the whole backward (the port's
``train.backward`` span, timed by CUDA events on the step's stream): the
cuDNN convs that ``conv_bwd_ms.train`` counts, and every other kernel of
the backward beside them."""

from benchmark import spans


def read(obs):
    return spans.per(obs, "train", "steps", "train.backward", device=True)
