"""Device milliseconds a ``predict_volume`` call in the kernels that
``aten::convolution`` launches (cuDNN's k4 stride-2 and transposed convs;
conv3 is launched outside it), from the profiler."""

from benchmark import kernels


def read(obs):
    if obs.get("kind") != "volume" or not obs["calls"]:
        return None
    s = kernels.under(obs["trace"], "aten::convolution")
    return 1e3 * s / obs["calls"] if s > 0 else None
