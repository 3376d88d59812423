"""The conv3 kernels' share of their roofline in the train step: the least
time of the window's conv3 work (its operations at the dtype's peak, or
its bytes at HBM's rate, whichever is longer, counted by ``counts``) over
the kernels' device time, in %."""

from benchmark import counts, harness, kernels


def read(obs):
    if obs.get("kind") != "train" or not obs["steps"]:
        return None
    t = harness.device_seconds(obs["trace"], kernels.is_conv3)
    if t <= 0:
        return None
    least = counts.roofline_seconds(
        obs["conv3_flops_per_step"] * obs["steps"],
        obs["conv3_bytes_per_step"] * obs["steps"], obs["dtype"])
    return 100.0 * least / t
