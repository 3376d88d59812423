"""Weights between the flax param tree, the TF goldens and the port.

The port stores every kernel in the JAX layout (k, k, k, Cin, Cout) under
the flax module path, so a flax tree and a port state_dict differ only in
nesting: ``params["down1"]["conv"]["kernel"]`` <-> ``"down1.conv.kernel"``.

* ``params_from_jax``: the flax ``{"params": {...}}`` tree as
  ``jax.tree.map(np.asarray, params)`` gives it -> state_dict.
* ``params_to_jax``: state_dict -> that tree (numpy leaves); exact inverse.
* ``params_from_tf_order``: the frozen TF goldens (tests/goldens/gen_*.npz,
  disc_*.npz; keys ``w_<layer>_<index>_<type>`` in TF build order) ->
  state_dict.  ``Conv{2,3}DTranspose`` stores (k.., Cout, Cin): the last two
  axes swap; a 1-D array is the layer's bias.
* ``params_geometry``: ``(wf, is3d)`` of a generator's state_dict.
* ``load_jax_state`` / ``state_to_jax``: a whole train state (the four param
  trees and the four Adam states ``count``, ``mu``, ``nu``) from the JAX
  ``CycleGANState`` with numpy leaves (``jax.tree.map(np.asarray, state)``)
  into the port's ``train.state.CycleGANState``, and back as nested dicts.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Dict, Mapping

import numpy as np
import torch

# TF build order of the generator's layers (tests/golden_utils.py:18-21).
GEN_ORDER = [("stem", None), ("down1", "conv"), ("down1", "down"),
             ("down2", "conv"), ("down2", "down"), ("up1", "conv"),
             ("up1", "up"), ("mid", None), ("up0", "conv"), ("up0", "up"),
             ("head", None), ("out", None)]
# ... and of the 3D discriminator's (tests/golden_utils.py:23-26).
DISC_ORDER_3D = [("down1", "conv"), ("down1", "down"), ("hack", None),
                 ("down2", "conv"), ("down2", "down"),
                 ("down3", "conv"), ("down3", "down"),
                 ("head", None), ("out", None)]
# ... and of the 2D one, which has no down1 (tests/golden_utils.py:28-30;
# the JAX package's compat.py:64)
DISC_ORDER_2D = [("hack", None), ("down2", "conv"), ("down2", "down"),
                 ("down3", "conv"), ("down3", "down"),
                 ("head", None), ("out", None)]
# the four networks of a train state, in the JAX CycleGANState's order
TREES = ("gg", "gf", "dx", "dy")

_GOLDEN_KEY = re.compile(r"w_(\d+)_(\d+)_(.+)")


def params_from_jax(tree: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """Flatten a flax param tree (numpy leaves) into a port state_dict."""
    tree = tree.get("params", tree)
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    def walk(node, prefix):
        for k, v in node.items():
            name = f"{prefix}.{k}" if prefix else k
            if isinstance(v, Mapping):
                walk(v, name)
            else:
                out[name] = torch.from_numpy(np.array(v, np.float32))

    walk(tree, "")
    return out


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """A port state_dict -> the flax ``{"params": {...}}`` tree, numpy
    leaves."""
    tree: Dict = {}
    for name, t in state_dict.items():
        node = tree
        *path, leaf = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = t.detach().to("cpu", torch.float32).numpy().copy()
    return {"params": tree}


def params_from_tf_order(weights: Mapping[str, np.ndarray],
                         order=GEN_ORDER) -> "OrderedDict[str, torch.Tensor]":
    """Golden ``.npz`` contents (any mapping of its keys), whose layers come
    in ``order`` (GEN_ORDER, DISC_ORDER_3D or DISC_ORDER_2D) ->
    state_dict."""
    layers: Dict[int, list] = {}
    for key in weights.keys():
        m = _GOLDEN_KEY.fullmatch(key)
        if m:
            layers.setdefault(int(m.group(1)), []).append(
                (int(m.group(2)), m.group(3), np.asarray(weights[key])))
    if len(layers) != len(order):
        raise ValueError(f"expected {len(order)} layers, got {len(layers)}")
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for (path, sub), li in zip(order, sorted(layers)):
        name = path if sub is None else f"{path}.{sub}"
        for _, tname, arr in sorted(layers[li], key=lambda t: t[0]):
            if "Transpose" in tname:
                arr = np.swapaxes(arr, -1, -2)
            leaf = "kernel" if arr.ndim >= 4 else "bias"
            out[f"{name}.{leaf}"] = torch.from_numpy(
                np.ascontiguousarray(arr, np.float32))
    return out


def params_geometry(state_dict: Mapping[str, torch.Tensor]):
    """``(wf, is3d)`` of a generator's state_dict, as the JAX package reads
    them (compat.py:171-176): the stem's width is 64 // wf (reference
    generator.py:53), a rank-5 kernel is 3D."""
    k = state_dict["stem.kernel"]
    return 64 // int(k.shape[-1]), k.dim() == 5


def _copy_tree(params: Mapping[str, torch.Tensor], tree: Mapping) -> None:
    src = params_from_jax(tree)
    if set(src) != set(params):
        raise ValueError(f"param trees differ: {sorted(set(src) ^ set(params))}")
    with torch.no_grad():
        for name, t in params.items():
            t.copy_(src[name])


def load_jax_state(state, jax_state) -> None:
    """Copy a JAX ``CycleGANState`` with numpy leaves into ``state`` (a port
    ``CycleGANState`` built for the same config) in place: ``step``, the
    four networks' parameters, and each Adam's ``count``, ``mu``, ``nu``."""
    state.step = int(np.asarray(jax_state.step))
    for t in TREES:
        _copy_tree(dict(getattr(state, t).named_parameters()),
                   getattr(jax_state, t))
        opt, jopt = getattr(state, "opt_" + t), getattr(jax_state, "opt_" + t)
        opt.count = int(np.asarray(jopt.count))
        _copy_tree(opt.mu, jopt.mu)
        _copy_tree(opt.nu, jopt.nu)


def state_to_jax(state) -> Dict:
    """A port ``CycleGANState`` -> ``{"step", "gg", ..., "opt_gg": {"count",
    "mu", "nu"}, ...}`` with numpy leaves in the flax layout (each tree
    ``{"params": {...}}``, ``step`` and ``count`` int32): the exact inverse
    of :func:`load_jax_state`."""
    out: Dict = {"step": np.int32(state.step)}
    for t in TREES:
        out[t] = params_to_jax(dict(getattr(state, t).named_parameters()))
        opt = getattr(state, "opt_" + t)
        out["opt_" + t] = {"count": np.int32(opt.count),
                           "mu": params_to_jax(opt.mu),
                           "nu": params_to_jax(opt.nu)}
    return out
