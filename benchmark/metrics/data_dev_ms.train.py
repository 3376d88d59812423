"""Device milliseconds a train step in the pipelines' device transforms
(scale, standardise, augment: the port's ``data.transform`` spans of
both datasets, timed by CUDA events on the pipeline's stream)."""

from benchmark import spans


def read(obs):
    return spans.per(obs, "train", "steps", "data.transform", device=True)
