"""Seeds derived from tuples of integers.

The JAX package derives every random stream with ``jax.random.fold_in``;
the port derives an integer seed from the same words with numpy's
``SeedSequence`` and seeds an explicit generator with it (a
``torch.Generator`` on the batch's device, or ``np.random.default_rng`` on
the host).  The global RNGs are never used."""

from __future__ import annotations

import numpy as np


def derive_seed(*words: int) -> int:
    """A 63-bit seed that is a pure function of ``words`` (non-negative
    ints): different tuples give independent streams."""
    state = np.random.SeedSequence([int(w) for w in words]).generate_state(
        1, np.uint64)
    return int(state[0]) & (2 ** 63 - 1)
