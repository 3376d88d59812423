"""cuDNN's share of its roofline in ``predict_volume``: the least time of
the k4 stride-2 down convs and the transposed convs that the port ran in
the cudnn form (each kind counted at the share of the window's convs of
that kind that the port counted there: ``down_cudnn`` against ``down_k4``,
``transpose_cudnn`` against ``transpose_phase``; operations at the cell's
dtype's peak or activations in and out and the weights once a call at
HBM's rate), over the device time of the operations launched inside
``aten::convolution``, in %.

In bf16 inference every 3D k3 conv runs on conv3, outside
``aten::convolution``, so only these two kinds of conv launch inside it:
in a traced ``volume-wf1-bf16`` call on an H100 that time is cuDNN's
forward engines for the two kinds and, under 0.4% of it, their layout
copies and a memset.  In f32 inference the port runs both kinds on its
own kernels, and the reader finds no device time and returns None."""

from benchmark import counts, kernels


def read(obs):
    if obs.get("kind") != "volume" or not obs["calls"]:
        return None
    t = kernels.under(obs["trace"], "aten::convolution")
    if t <= 0:
        return None
    forms, work = obs["forms"], obs["work"]
    least = counts.least_seconds(
        [(work["k4"], counts.form_share(forms, "down_cudnn", "down_k4")),
         (work["transposed"], counts.form_share(forms, "transpose_cudnn",
                                                "transpose_phase"))],
        obs["tiles"], obs["calls"], obs["dtype"])
    return 100.0 * least / t
