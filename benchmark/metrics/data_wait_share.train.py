"""Share of the window the host spent waiting for the next zipped batch
(the benchmark's span around each ``next()``), in %."""


def read(obs):
    if obs.get("kind") != "train":
        return None
    return 100.0 * obs["spans"].get("data.next", 0.0) / obs["window_s"]
