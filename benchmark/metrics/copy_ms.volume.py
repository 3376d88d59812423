"""Device milliseconds a ``predict_volume`` call in host-to-device and
device-to-host copies, from the profiler."""

from benchmark import harness, kernels


def read(obs):
    if obs.get("kind") != "volume" or not obs["calls"]:
        return None
    s = harness.device_seconds(obs["trace"], kernels.is_host_copy)
    return 1e3 * s / obs["calls"] if s > 0 else None
