"""Device milliseconds a train step in the four Adam updates (the port's
``train.adam`` span, timed by CUDA events on the step's stream)."""

from benchmark import spans


def read(obs):
    return spans.per(obs, "train", "steps", "train.adam", device=True)
