"""The train step's share of the cards' peak: the benchmark's FLOP count
of a step (``counts.train_step_flops``) times the window's steps, over the
window's seconds and the dtype's peak times the cards, in %."""

from benchmark import counts


def read(obs):
    if obs.get("kind") != "train" or not obs["steps"]:
        return None
    peak = counts.PEAK_FLOPS[obs["dtype"]] * obs["devices"]
    return 100.0 * obs["flops_per_step"] * obs["steps"] / obs["window_s"] / peak
