"""The conv3 kernels' share of their roofline in ``predict_volume``: the
least time of the convs they ran for the window's real tiles (operations
at the peak of the cell's dtype or bytes at HBM's rate, the weights once
a call) over the kernels' device time, in %.  Those convs are the k3
layers and, by the share of the window's transposed convs that the port
counted in the phase form (``transpose_phase`` against
``transpose_cudnn``), the transposed layers, which the phase form runs as
a k3 conv on conv3: each counted at its own work, not at the zero taps
the form multiplies."""

from benchmark import counts, harness, kernels


def read(obs):
    if obs.get("kind") != "volume" or not obs["calls"]:
        return None
    t = harness.device_seconds(obs["trace"], kernels.is_conv3)
    if t <= 0:
        return None
    work = obs["work"]
    phase = counts.form_share(obs["forms"], "transpose_phase",
                              "transpose_cudnn")
    least = counts.least_seconds(
        [(work["k3"], 1.0), (work["transposed"], phase)], obs["tiles"],
        obs["calls"], obs["dtype"])
    return 100.0 * least / t
