"""Device milliseconds a train step in the kernels that
``aten::convolution_backward`` launches (cuDNN's data and weight
gradients, conv3's included), from the profiler."""

from benchmark import kernels


def read(obs):
    if obs.get("kind") != "train" or not obs["steps"]:
        return None
    s = kernels.under(obs["trace"], "aten::convolution_backward")
    return 1e3 * s / obs["steps"] if s > 0 else None
