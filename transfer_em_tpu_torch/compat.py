"""Interop with reference TF/Keras assets (janelia-flyem/transfer_em).

Counterpart of ``transfer_em_tpu/compat.py``.  A user migrating from the
reference owns Keras artifacts: generators and discriminators built by
``unet_generator`` / ``discriminator``, saved as SavedModel directories or
``.h5`` files, and ``tf.train.Checkpoint``s of a training run.  This module
converts them into the port's modules:

    gen, params = compat.load_tf_generator("gen_dir_or.h5")
    disc, params = compat.load_tf_discriminator("disc.h5")
    prior = compat.prior_from_tf_generator("prior.h5", "down2")
    state, wf, is3d = compat.load_reference_checkpoint("checkpoints/train_x")
    compat.export_tf_savedmodel("our_export_dir", "tf_savedmodel_dir")

The weight mapping is the JAX package's (its tests hold it against the live
reference models): Keras functional models enumerate their weight groups in
build order, nested sub-models flattened depth-first and shared layers kept
once; plain conv kernels are (k.., Cin, Cout) in both frameworks,
``Conv*DTranspose`` kernels (k.., Cout, Cin) and swapped; the only bias is
the discriminator's last 1x1.  ``wf`` and 2D/3D come from the weights.

Returned modules live on ``device`` (default ``cuda``, raising where it is
absent), with the weights also returned as a state_dict of float32 CPU
tensors.  TensorFlow is imported only inside the functions that read or
write TF assets; importing this module loads neither TF nor torch
(torch comes with the first function that builds a module).
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import warnings
from collections import OrderedDict
from typing import Callable, Dict, List, Mapping, Sequence, Tuple

import numpy as np

# (submodule, nested conv) in reference build order: the generator
# (reference models/generator.py:53-115) and the discriminators (reference
# models/discriminator.py:39-103; the 2D model never builds down1, the
# HACK quirk).  The same lists as models/convert.py's GEN_ORDER and
# DISC_ORDER_*, kept here so that this module imports no torch.
GEN_SLOTS: Tuple[Tuple[str, "str | None"], ...] = (
    ("stem", None), ("down1", "conv"), ("down1", "down"),
    ("down2", "conv"), ("down2", "down"), ("up1", "conv"), ("up1", "up"),
    ("mid", None), ("up0", "conv"), ("up0", "up"),
    ("head", None), ("out", None))
DISC_SLOTS_3D: Tuple[Tuple[str, "str | None"], ...] = (
    ("down1", "conv"), ("down1", "down"), ("hack", None),
    ("down2", "conv"), ("down2", "down"), ("down3", "conv"),
    ("down3", "down"), ("head", None), ("out", None))
DISC_SLOTS_2D: Tuple[Tuple[str, "str | None"], ...] = (
    ("hack", None), ("down2", "conv"), ("down2", "down"),
    ("down3", "conv"), ("down3", "down"), ("head", None), ("out", None))

WeightGroup = Tuple[str, List[np.ndarray], str]  # (name, arrays, class)
NETWORKS = ("generator_g", "generator_f", "discriminator_x",
            "discriminator_y")  # the reference checkpoint's names
_ATTR_SUFFIX = "/.ATTRIBUTES/VARIABLE_VALUE"


def _as_keras_model(source):
    """A live Keras model, or a path (.h5 / .keras file) loaded as one."""
    if isinstance(source, str):
        import tensorflow as tf
        return tf.keras.models.load_model(source, compile=False)
    return source


def keras_conv_weights(model, trainable_only: bool = False
                       ) -> List[WeightGroup]:
    """All unique weight groups of a Keras functional model, build order,
    nested sub-models flattened, shared layers kept once: by variable id
    (live models share layer objects), and by (layer name, value digest)
    (an ``.h5`` round trip materialises a shared layer once per nested
    model, with the same name and values).  ``trainable_only`` skips layers
    frozen themselves or inside a frozen nested model: a ``disc_prior``
    sub-model (reference cgan.py:21-29 freezes it)."""
    import tensorflow as tf
    out: List[WeightGroup] = []
    seen_ids: set = set()
    seen_sigs: set = set()

    def visit(layer, frozen=False):
        frozen = frozen or not layer.trainable
        if isinstance(layer, tf.keras.Model) and layer is not model:
            for sub in layer.layers:
                visit(sub, frozen)
        elif layer.weights:
            if trainable_only and frozen:
                return
            fresh = [w for w in layer.weights if id(w) not in seen_ids]
            if not fresh:
                return
            arrays = [np.asarray(w) for w in fresh]
            h = hashlib.sha1()
            for a in arrays:
                h.update(np.ascontiguousarray(a).tobytes())
            sig = (layer.name, h.hexdigest())
            if sig in seen_sigs:
                return
            seen_ids.update(id(w) for w in fresh)
            seen_sigs.add(sig)
            out.append((layer.name, arrays, type(layer).__name__))

    for layer in model.layers:
        visit(layer)
    return out


def savedmodel_conv_weights(path: str) -> List[WeightGroup]:
    """Conv weight groups from a TF SavedModel's restored variables, build
    order (``tf.saved_model.load(path).variables``, which both Keras-2-era
    SavedModels and Keras 3 exports expose).  Non-conv state is skipped; a
    bias joins the preceding kernel's group and is refused when there is
    none (dropping it would zero that layer's bias).  Transposed-conv
    kernels are not told apart by class here: :func:`assign_weights` swaps
    the ``up`` slots' axes, and each slot's shape is checked."""
    import tensorflow as tf
    obj = tf.saved_model.load(path)
    variables = getattr(obj, "variables", None)
    if variables is None:
        raise ValueError(f"SavedModel at {path!r} exposes no variables — not "
                         "a Keras-exported model?")
    groups: List[WeightGroup] = []
    for v in variables:
        name = v.name.split(":")[0]
        layer, _, kind = name.rpartition("/")
        arr = np.asarray(v)
        if kind == "kernel" and arr.ndim >= 4:
            groups.append((layer, [arr], "SavedModelVariable"))
        elif kind == "bias":
            if not (groups and groups[-1][0] == layer):
                raise ValueError(
                    f"bias variable {v.name!r} has no preceding kernel of "
                    f"layer {layer!r} to join — silently dropping it would "
                    "zero that layer's bias; not a reference-architecture "
                    "SavedModel?")
            groups[-1][1].append(arr)
    return groups


def _conv_weight_groups(source, trainable_only: bool = False
                        ) -> List[WeightGroup]:
    """Weight groups from a live model, an ``.h5`` / ``.keras`` file or a
    SavedModel directory."""
    if isinstance(source, str) and os.path.isdir(source) and os.path.exists(
            os.path.join(source, "saved_model.pb")):
        if trainable_only:
            raise ValueError(
                "a prior-carrying discriminator can only be converted from "
                "a live Keras model or .h5 file: SavedModel variables do not "
                "reliably record layer-level freezing, so the prior's "
                "weights cannot be told apart")
        return savedmodel_conv_weights(source)
    return keras_conv_weights(_as_keras_model(source), trainable_only)


def params_geometry(params: Mapping) -> Tuple[int, bool]:
    """``(wf, is3d)`` of a generator's state_dict (models/convert.py)."""
    from .models.convert import params_geometry as geometry
    return geometry(params)


def assign_weights(template: Mapping, slots: Sequence[Tuple[str, "str | None"]],
                   groups: Sequence[WeightGroup]) -> "OrderedDict":
    """Reference weight groups (build order) -> a new state_dict shaped as
    ``template`` (a module's state_dict), slot by slot, every shape
    checked."""
    import torch
    if len(groups) != len(slots):
        raise ValueError(
            f"weight-group count {len(groups)} != expected {len(slots)} "
            f"slots — not a reference-architecture model? "
            f"(groups: {[n for n, _, _ in groups]})")
    out = OrderedDict((k, v.detach().to("cpu", torch.float32).clone())
                      for k, v in template.items())
    for (path, sub), (name, arrays, cls) in zip(slots, groups):
        prefix = path if sub is None else f"{path}.{sub}"
        for arr in arrays:
            arr = np.asarray(arr)
            if arr.ndim >= 4:  # conv kernel
                if "Transpose" in cls or sub == "up":
                    arr = np.swapaxes(arr, -1, -2)
                key = prefix + ".kernel"
                if tuple(out[key].shape) != arr.shape:
                    raise ValueError(
                        f"kernel shape mismatch at {path}/{sub or ''} "
                        f"({name}): ours {tuple(out[key].shape)} vs theirs "
                        f"{arr.shape}")
            else:
                key = prefix + ".bias"
                if key not in out:
                    raise ValueError(
                        f"reference layer {name} carries a bias but our "
                        f"{path}/{sub or ''} slot has none")
                if tuple(out[key].shape) != arr.shape:
                    raise ValueError(
                        f"bias shape mismatch at {path}/{sub or ''} "
                        f"({name}): ours {tuple(out[key].shape)} vs theirs "
                        f"{arr.shape}")
            out[key] = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
    return out


def load_tf_generator(source, device="cuda"):
    """A reference Keras generator (live model, .h5 file or SavedModel
    directory) -> ``(UNetGenerator on device in eval mode, state_dict)``;
    ``wf`` and 2D/3D from the stem (width 64 // wf, rank 5 is 3D)."""
    from .device import resolve_device
    from .models.generator import UNetGenerator
    dev = resolve_device(device)
    groups = _conv_weight_groups(source)
    if not groups or groups[0][1][0].ndim < 4:
        raise ValueError("first weight group is not a conv kernel")
    stem = groups[0][1][0]
    gen = UNetGenerator(wf=64 // int(stem.shape[-1]), is3d=stem.ndim == 5)
    params = assign_weights(gen.state_dict(), GEN_SLOTS, groups)
    gen.load_state_dict(params)
    return gen.to(dev).eval(), params


def load_tf_discriminator(source, disc_prior=None, device="cuda"):
    """A reference Keras discriminator -> ``(Discriminator on device in eval
    mode, state_dict)``; wf and 2D/3D from the weights (3D: 9 groups from
    down1; 2D: 7 from the 16-wide hack conv).  ``disc_prior``: for one built
    WITH a prior (reference discriminator.py:62-70), the same frozen
    feature extractor (a ``create_prior_helper`` tap, which carries its
    width as ``channels``); the prior's frozen weights in the asset are
    left out of the mapping and the post-concat conv keeps its widened
    shape."""
    from .device import resolve_device
    from .models.discriminator import Discriminator
    dev = resolve_device(device)
    groups = _conv_weight_groups(source, trainable_only=disc_prior is not None)
    if not groups:
        raise ValueError("no conv weight groups found in the Keras model")
    first = groups[0][1][0]
    is3d = first.ndim == 5
    if is3d:
        wf, slots = 64 // int(first.shape[-1]), DISC_SLOTS_3D
    else:
        if len(groups) < 2:
            raise ValueError("too few weight groups for a discriminator")
        wf, slots = 256 // int(groups[1][1][0].shape[-1]), DISC_SLOTS_2D
    disc = Discriminator(wf=wf, is3d=is3d, disc_prior=disc_prior,
                         prior_channels=(disc_prior.channels if disc_prior
                                         else 0))
    params = assign_weights(disc.state_dict(), slots, groups)
    disc.load_state_dict(params)
    return disc.to(dev).eval(), params


def _group_arrays(arrays: Sequence[np.ndarray]) -> List[WeightGroup]:
    """Flat build-order arrays -> weight groups: each >= 4-D kernel starts
    a group, a following low-rank bias joins it."""
    groups: List[WeightGroup] = []
    for a in arrays:
        if a.ndim >= 4:
            groups.append(("ckpt", [a], "SavedModelVariable"))
        elif groups:
            groups[-1][1].append(a)
        else:
            raise ValueError("weight list does not start with a conv kernel")
    return groups


def _ckpt_modern(rd, keys, name):
    """The Keras 3 ``tf.train.Checkpoint`` layout: weights under
    '<name>_optimizer/_trainable_variables/<i>', Adam m and v paired per
    weight in '<name>_optimizer/_variables/<j>' (m, v of weight 0, then
    weight 1, ...), the step in '_iterations'."""
    pref = f"{name}_optimizer/"
    tv, sv = {}, {}
    for k in keys:
        m = re.match(re.escape(pref) + r"_trainable_variables/(\d+)/", k)
        if m:
            tv[int(m.group(1))] = rd.get_tensor(k)
            continue
        m = re.match(re.escape(pref) + r"_variables/(\d+)/", k)
        if m:
            sv[int(m.group(1))] = rd.get_tensor(k)
    ws = [tv[i] for i in range(len(tv))]
    if not ws:
        raise ValueError(
            f"{name}: no weights under {pref + '_trainable_variables/'!r} — "
            "checkpoint saved before the optimizer was built?")
    idx = sorted(sv)
    if len(idx) != 2 * len(ws):
        raise ValueError(f"{name}: {len(idx)} optimizer slot tensors for "
                         f"{len(ws)} weights (expected m+v per weight)")
    ms = [sv[idx[2 * i]] for i in range(len(ws))]
    vs = [sv[idx[2 * i + 1]] for i in range(len(ws))]
    it = int(rd.get_tensor(pref + "_iterations" + _ATTR_SUFFIX))
    return ws, ms, vs, it


def _slot_key(weight_key: str, opt_name: str, slot: str) -> str:
    """The Adam slot path of a Keras-2-era object-graph weight key: one
    definition for :func:`_ckpt_legacy` and :func:`_frozen_disc_y_arrays`,
    which must agree on it."""
    return (weight_key[:-len(_ATTR_SUFFIX)]
            + f"/.OPTIMIZER_SLOT/{opt_name}/{slot}" + _ATTR_SUFFIX)


def _frozen_disc_y_arrays(rd, keys) -> List[np.ndarray]:
    """The weights of discriminator_y's frozen sub-model (its ``disc_prior``)
    as the checkpoint stores them, build order; empty when the run had no
    prior.  Keras 3 stores non-trainables under the model's own path
    ('discriminator_y/_operations/.../_kernel'); the Keras-2-era layout
    stores them like any weight but without Adam slots."""
    keyset = set(keys)
    modern = [k for k in keys
              if k.startswith("discriminator_y/")
              and (k.endswith("/_kernel" + _ATTR_SUFFIX)
                   or k.endswith("/_bias" + _ATTR_SUFFIX))]
    modern.sort(key=lambda k: tuple(
        int(n) for n in re.findall(r"_operations/(\d+)", k)))
    legacy = [k for k in keys
              if k.startswith("discriminator_y/")
              and ".OPTIMIZER_SLOT" not in k
              and (k.endswith("/kernel" + _ATTR_SUFFIX)
                   or k.endswith("/bias" + _ATTR_SUFFIX))
              and _slot_key(k, "discriminator_y_optimizer", "m")
              not in keyset]
    legacy.sort(key=lambda k: tuple(
        int(n) for n in re.findall(r"layer_with_weights-(\d+)", k)))
    return [rd.get_tensor(k) for k in modern + legacy]


def _check_prior_matches(frozen: Sequence[np.ndarray], disc_prior) -> None:
    """Refuse a ``disc_prior`` whose weights are not the frozen prior
    weights the checkpoint stores (a wrong prior of the right architecture
    would import silently and diverge from the run).  Priors built by this
    package carry ``.params``; an opaque callable is passed with a
    warning."""
    if not frozen:
        return
    params = getattr(disc_prior, "params", None)
    if params is None:
        warnings.warn(
            "disc_prior exposes no .params — cannot cross-check it against "
            "the frozen prior weights the checkpoint stores; a wrong prior "
            "of the right architecture would import silently and diverge "
            "from the run it continues.  Build the prior with "
            "create_prior_helper()/prior_from_tf_generator() to enable the "
            "check.", stacklevel=3)
        return
    leaves = [np.asarray(t.detach().to("cpu")) for t in params.values()]
    for i, arr in enumerate(frozen):
        arr = np.asarray(arr)
        cands = [arr] if arr.ndim < 4 else [arr, np.swapaxes(arr, -1, -2)]
        if not any(l.shape == c.shape and np.allclose(l, c, atol=1e-6)
                   for l in leaves for c in cands):
            raise ValueError(
                f"disc_prior mismatch: frozen prior weight {i} (shape "
                f"{arr.shape}) stored in the checkpoint matches no parameter "
                "of the passed disc_prior — wrong prior model? Pass the same "
                "frozen prior the run was trained with (reference "
                "cgan.py:21-29)")


def _ckpt_legacy(rd, keys, name):
    """The Keras-2-era layout the reference shipped against: weights at
    '<name>/layer_with_weights-.../{kernel,bias}/.ATTRIBUTES/VARIABLE_VALUE'
    (nested sub-models nest the index; a numeric-tuple sort restores build
    order), Adam slots at the weight path + '.OPTIMIZER_SLOT/<name>_
    optimizer/{m,v}', the step at '<name>_optimizer/iter'.  Only weights
    with an Adam m slot are taken: a frozen prior's have none."""
    slot = lambda k, s: _slot_key(k, f"{name}_optimizer", s)
    keyset = set(keys)
    cands = [k for k in keys
             if k.startswith(name + "/") and ".OPTIMIZER_SLOT" not in k
             and (k.endswith("/kernel" + _ATTR_SUFFIX)
                  or k.endswith("/bias" + _ATTR_SUFFIX))]
    wkeys = [k for k in cands if slot(k, "m") in keyset]
    if cands and not wkeys:
        raise ValueError(
            f"{name}: found {len(cands)} weights but none has an Adam slot "
            f"at e.g. {slot(cands[0], 'm')!r} — checkpoint saved before any "
            f"training step, or a non-'{name}_optimizer' optimizer name?")

    def order(k):
        nums = tuple(int(n) for n in re.findall(r"layer_with_weights-(\d+)",
                                                k))
        return nums + (0 if k.endswith("/kernel" + _ATTR_SUFFIX) else 1,)

    wkeys.sort(key=order)
    ws = [rd.get_tensor(k) for k in wkeys]
    ms = [rd.get_tensor(slot(k, "m")) for k in wkeys]
    vs = [rd.get_tensor(slot(k, "v")) for k in wkeys]
    it = int(rd.get_tensor(f"{name}_optimizer/iter" + _ATTR_SUFFIX))
    return ws, ms, vs, it


def _read_checkpoint(ckpt_path: str, disc_prior) -> Dict:
    """Each network's (weights, m, v, step) from a reference checkpoint,
    either layout, with the prior checks of :func:`load_reference_checkpoint`."""
    import tensorflow as tf
    if os.path.isdir(ckpt_path):
        latest = tf.train.latest_checkpoint(ckpt_path)
        if latest is None:
            raise ValueError(f"no TF checkpoint found under {ckpt_path!r}")
        ckpt_path = latest
    rd = tf.train.load_checkpoint(ckpt_path)
    keys = sorted(rd.get_variable_to_shape_map())
    if any(k.startswith("generator_g_optimizer/_trainable_variables/")
           for k in keys):
        extract = _ckpt_modern
    elif any(k.startswith("generator_g/layer_with_weights") for k in keys):
        extract = _ckpt_legacy
        if not any(".OPTIMIZER_SLOT" in k for k in keys):
            # Keras-2-era Adam makes its slots in the first apply_gradients:
            # diagnose that here, before the slot-less-means-frozen rule
            # reads every discriminator_y weight as a prior's
            raise ValueError(
                "checkpoint has no Adam optimizer slots at all — it was "
                "saved before any training step (Keras creates m/v slots "
                "lazily in apply_gradients); import a checkpoint written "
                "after at least one train_step, or load the weights via "
                "load_tf_generator/load_tf_discriminator instead")
    elif any(k.startswith("generator_g/") for k in keys):
        raise ValueError(
            "checkpoint stores generator_g but no optimizer variables — "
            "saved before the optimizer was built / before any training "
            "step; import a checkpoint written after at least one "
            "train_step")
    else:
        raise ValueError(
            "not a reference EM2EM checkpoint (no generator_g weights in "
            "either the Keras-2 or Keras-3 layout); keys start with: "
            f"{sorted({k.split('/')[0] for k in keys})}")
    frozen = _frozen_disc_y_arrays(rd, keys)
    if frozen and disc_prior is None:
        raise ValueError(
            f"checkpoint stores {len(frozen)} frozen prior weights under "
            "discriminator_y — the run was trained WITH a disc_prior "
            "(reference cgan.py:59) — but none was passed; rebuild the "
            "run's frozen prior (e.g. create_prior_helper(prior.h5, "
            "last_layer)) and pass it as disc_prior=")
    _check_prior_matches(frozen, disc_prior)
    return {name: extract(rd, keys, name) for name in NETWORKS}


def load_reference_checkpoint(ckpt_path: str, disc_prior=None,
                              device="cuda"):
    """A reference ``tf.train.Checkpoint`` (cgan.py:86-95) -> the port's
    ``CycleGANState`` on ``device``: the four networks' weights and the four
    Keras Adams' count, m and v, so the run continues here with its
    optimizer memory (the port's Adam is Keras's exact update).  Returns
    ``(state, wf, is3d)``; ``EM2EM.from_reference_checkpoint`` is the
    one-call version.

    ``ckpt_path``: a checkpoint prefix (``.../ckpt-12``) or a directory
    holding one.  Both on-disk layouts are read: the Keras-2-era object
    graph the reference shipped against and the Keras 3 one current TF
    writes.  ``disc_prior``: for a run trained WITH a prior, the same
    frozen feature extractor; the checkpoint's own copy of its weights is
    not imported but is held against it."""
    import torch

    from .config import CycleGANConfig
    from .device import resolve_device
    from .train.cgan import create_state

    dev = resolve_device(device)
    per_model = _read_checkpoint(ckpt_path, disc_prior)
    stem = per_model["generator_g"][0][0]
    wf, is3d = 64 // int(stem.shape[-1]), stem.ndim == 5
    state = create_state(CycleGANConfig(is3d=is3d, wf=wf), 0, dev,
                         disc_prior)
    slots = {"gg": GEN_SLOTS, "gf": GEN_SLOTS,
             "dx": DISC_SLOTS_3D if is3d else DISC_SLOTS_2D}
    slots["dy"] = slots["dx"]
    for tree, name in zip(("gg", "gf", "dx", "dy"), NETWORKS):
        ws, ms, vs, it = per_model[name]
        net = getattr(state, tree)
        template = net.state_dict()
        try:
            params, mu, nu = (assign_weights(template, slots[tree],
                                             _group_arrays(a))
                              for a in (ws, ms, vs))
            params, mu, nu = dict(params), dict(mu), dict(nu)
        except ValueError as e:
            if name == "discriminator_y":
                raise ValueError(
                    f"{e} — discriminator_y's shapes depend on its "
                    "disc_prior: a run trained with one needs the same "
                    "frozen prior callable passed as disc_prior= (and one "
                    "trained without must not pass one)") from e
            raise
        with torch.no_grad():
            for k, p in net.named_parameters():
                p.copy_(params[k])
        opt = getattr(state, "opt_" + tree)
        opt.count = it
        opt.mu = {k: mu[k].to(dev) for k in opt.mu}
        opt.nu = {k: nu[k].to(dev) for k in opt.nu}
    state.step = per_model["generator_g"][3]
    return state, wf, is3d


# -- the reverse: the port's export as a reference-architecture SavedModel --

def _crop_pairs(have: Sequence[int], want: Sequence[int]):
    """Keras Cropping per axis: (lo, hi), the odd voxel on the high side
    (ops/convs.py asymmetric_center_crop)."""
    return tuple(((h - w) // 2, (h - w) - (h - w) // 2)
                 for h, w in zip(have, want))


def keras_generator(wf: int, is3d: bool, dimsize: int):
    """The reference generator's architecture as one flat Keras functional
    model on a (dimsize,)*n input, its conv layers built in ``GEN_SLOTS``
    order with the reference's layers: ``Conv{2,3}D`` without bias (k3
    VALID, k4 stride-2 VALID), ``Conv{2,3}DTranspose(4, 2, "same")``
    without bias, ``LeakyReLU(0.3)``, ``Dropout(0.5)``, cropping and
    concatenation.  Returns ``(model, conv layers in GEN_SLOTS order)``."""
    import tensorflow as tf
    L = tf.keras.layers
    n = 3 if is3d else 2
    conv, convt = (L.Conv3D, L.Conv3DTranspose) if is3d else (L.Conv2D,
                                                               L.Conv2DTranspose)
    crop = L.Cropping3D if is3d else L.Cropping2D
    c1, c2, c4 = 64 // wf, 128 // wf, 256 // wf
    layers = []

    def add(layer, x):
        layers.append(layer)
        return layer(x)

    def act(x):
        return L.LeakyReLU(negative_slope=0.3)(x)

    def down(x, f, name):
        skip = act(add(conv(f, 3, use_bias=False, name=f"{name}_conv"), x))
        y = act(add(conv(f, 4, strides=2, use_bias=False,
                         name=f"{name}_down"), skip))
        return y, skip

    def up(x, f, name):
        y = act(add(conv(2 * f, 3, use_bias=False, name=f"{name}_conv"), x))
        y = add(convt(f, 4, strides=2, padding="same", use_bias=False,
                      name=f"{name}_up"), y)
        return act(L.Dropout(0.5)(y))

    def join(a, skip):
        have, want = skip.shape[1:-1], a.shape[1:-1]
        return L.Concatenate()([a, crop(_crop_pairs(have, want))(skip)])

    inp = tf.keras.Input((dimsize,) * n + (1,))
    x = act(add(conv(c1, 3, use_bias=False, name="stem"), inp))
    x, skip0 = down(x, c1, "down1")
    x, skip1 = down(x, c2, "down2")
    x = join(up(x, c2, "up1"), skip1)
    x = act(add(conv(c4, 3, use_bias=False, name="mid"), x))
    x = join(up(x, c1, "up0"), skip0)
    x = act(add(conv(c2, 3, use_bias=False, name="head"), x))
    x = add(conv(1, 3, use_bias=False, name="out"), x)
    return tf.keras.Model(inp, x), layers


def export_tf_savedmodel(model_dir: str, out_dir: str) -> None:
    """One of the port's exported generators (``infer.export``: npz or
    msgpack, with meta.json) as a TF SavedModel, the reverse of
    :func:`load_tf_generator`, so a reference user's TF serving stack can
    run it.  ``out_dir`` receives:

    * a ``serving_default`` signature, float32 ``(batch, *spatial, 1)`` ->
      float32 (TF-Serving, Keras 3's ``TFSMLayer``);
    * a ``predict`` function, so ``tf.saved_model.load(out_dir).predict``
      stands in for the reference's ``model.predict`` (utils.py:107-108);
    * the restored object's ``variables``, in the reference's build order,
      which :func:`load_tf_generator` (and the JAX package's) reads back;
    * the export's ``meta.json`` (reference utils.py:29-36 keys).

    The JAX package exports through ``jax2tf``; here the reference
    generator is rebuilt as a Keras model (:func:`keras_generator`), the
    port's weights copied in (transposed convs swapped to (k.., Cout,
    Cin)), and written through Keras's export archive."""
    import keras
    import tensorflow as tf

    from .infer.export import META_FILE, load_generator
    gen, meta = load_generator(model_dir, device="cpu")
    sd = gen.state_dict()
    model, layers = keras_generator(meta.wf, meta.is3d, meta.dimsize)
    for (path, sub), layer in zip(GEN_SLOTS, layers):
        k = sd[(path if sub is None else f"{path}.{sub}") + ".kernel"]
        k = k.detach().numpy()
        layer.set_weights([np.swapaxes(k, -1, -2) if sub == "up" else k])
    spatial = (meta.dimsize,) * (3 if meta.is3d else 2)
    archive = keras.export.ExportArchive()
    archive.track(model)
    archive.add_endpoint(
        "predict", lambda x: model(x, training=False),
        input_signature=[tf.TensorSpec((None,) + spatial + (1,), tf.float32,
                                       name="input")])
    archive.write_out(out_dir, verbose=False)
    shutil.copyfile(os.path.join(model_dir, META_FILE),
                    os.path.join(out_dir, META_FILE))


def prior_from_tf_generator(source, last_layer: str,
                            device="cuda") -> Callable:
    """A frozen feature extractor from a reference-architecture Keras model
    (the create_prior_helper .h5 contract, reference cgan.py:21-29): the
    weights converted, the submodule ``last_layer`` ("down1", "down2",
    "mid", ...: the port's names) tapped.  Returns a ``disc_prior``."""
    from .train.cgan import _tap_prior
    gen, _ = load_tf_generator(source, device)
    return _tap_prior(gen, last_layer)
