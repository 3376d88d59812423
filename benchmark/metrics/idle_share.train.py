"""Share of the traced window in which no operation ran on the card
(averaged over the cards), in %."""


def read(obs):
    if obs.get("kind") != "train":
        return None
    t = obs["trace"]
    if t["busy_s"] <= 0:  # nothing ran on a card: nothing to read
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
