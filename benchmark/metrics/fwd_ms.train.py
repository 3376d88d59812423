"""Device milliseconds a train step in the generators' and discriminators'
forwards and the losses (the port's ``train.forward`` span, timed by CUDA
events on the step's stream)."""

from benchmark import spans


def read(obs):
    return spans.per(obs, "train", "steps", "train.forward", device=True)
