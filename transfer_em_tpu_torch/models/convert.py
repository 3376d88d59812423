"""Weights between the flax param tree, the TF goldens and the port.

The port stores every kernel in the JAX layout (k, k, k, Cin, Cout) under
the flax module path, so a flax tree and a port state_dict differ only in
nesting: ``params["down1"]["conv"]["kernel"]`` <-> ``"down1.conv.kernel"``.

* ``params_from_jax``: the flax ``{"params": {...}}`` tree as
  ``jax.tree.map(np.asarray, params)`` gives it -> state_dict.
* ``params_to_jax``: state_dict -> that tree (numpy leaves); exact inverse.
* ``params_from_tf_order``: the frozen TF goldens (tests/goldens/gen_*.npz,
  keys ``w_<layer>_<index>_<type>`` in TF build order) -> state_dict.
  ``Conv3DTranspose`` stores (k, k, k, Cout, Cin): the last two axes swap.
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


def params_from_tf_order(weights: Mapping[str, np.ndarray]
                         ) -> "OrderedDict[str, torch.Tensor]":
    """Golden ``.npz`` contents (any mapping of its keys) -> state_dict."""
    layers: Dict[int, list] = {}
    for key in weights.keys():
        m = _GOLDEN_KEY.fullmatch(key)
        if m:
            layers.setdefault(int(m.group(1)), []).append(
                (int(m.group(2)), m.group(3), np.asarray(weights[key])))
    if len(layers) != len(GEN_ORDER):
        raise ValueError(f"expected {len(GEN_ORDER)} generator layers, got "
                         f"{len(layers)}")
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for (path, sub), li in zip(GEN_ORDER, sorted(layers)):
        name = path if sub is None else f"{path}.{sub}"
        for _, tname, arr in sorted(layers[li], key=lambda t: t[0]):
            if arr.ndim < 4:
                raise ValueError(f"layer {name}: unexpected {tname} "
                                 f"{arr.shape} (the generator has no bias)")
            if "Transpose" in tname:
                arr = np.swapaxes(arr, -1, -2)
            out[f"{name}.kernel"] = torch.from_numpy(
                np.ascontiguousarray(arr, np.float32))
    return out
