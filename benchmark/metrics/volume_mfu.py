"""``predict_volume``'s share of the card's peak at the cell's dtype: the
real tiles of the window's calls (pad slots left out) times the
generator's forward FLOPs a tile, over the window's seconds and the peak
(495 TFLOP/s for float32, 989 for bf16), in %."""

from benchmark import counts


def read(obs):
    if obs.get("kind") != "volume" or not obs["calls"]:
        return None
    flops = obs["tiles"] * obs["gen_flops_per_tile"]
    return 100.0 * flops / obs["window_s"] / counts.PEAK_FLOPS[obs["dtype"]]
