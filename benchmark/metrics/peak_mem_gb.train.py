"""Peak device memory of the window, ``torch.cuda.max_memory_allocated``
after a reset at its start, on the fullest card, in GB."""


def read(obs):
    if obs.get("kind") != "train" or not obs["window_peak_bytes"]:
        return None
    return obs["window_peak_bytes"] / 1e9
