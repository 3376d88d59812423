"""The conv3 kernels' share of their roofline in ``predict_volume``: the
least time of the k3 convs of the window's real tiles (operations at the
float32 peak or bytes at HBM's rate, the weights once a call) over the
kernels' device time, in %."""

from benchmark import counts, harness, kernels


def read(obs):
    if obs.get("kind") != "volume" or not obs["calls"]:
        return None
    t = harness.device_seconds(obs["trace"], kernels.is_conv3)
    if t <= 0:
        return None
    least = counts.roofline_seconds(
        obs["conv3_flops_per_tile"] * obs["tiles"],
        obs["conv3_bytes_per_tile"] * obs["tiles"]
        + obs["conv3_weight_bytes"] * obs["calls"], obs["dtype"])
    return 100.0 * least / t
