"""The down4 kernel's share of its roofline in ``predict_volume``: the
least time of the k4 stride-2 down convs of the window's real tiles
(operations at the float32 peak or x, y and w once a call at HBM's rate),
counted at the share of the window's down convs that the port ran in the
down4 form (``down_k4`` against ``down_cudnn``), over the
``down4_tc_kernel`` rows' device time, in %."""

from benchmark import counts, harness, kernels


def read(obs):
    if obs.get("kind") != "volume" or not obs["calls"]:
        return None
    t = harness.device_seconds(obs["trace"], kernels.is_down4)
    share = counts.form_share(obs["forms"], "down_k4", "down_cudnn")
    if t <= 0 or share <= 0:
        return None
    least = counts.least_seconds([(obs["work"]["k4"], share)], obs["tiles"],
                                 obs["calls"], obs["dtype"])
    return 100.0 * least / t
