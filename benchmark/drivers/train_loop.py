"""Training traffic: ``EM2EM.train``'s loop body on seeded volumes.

Set-up draws the x and y volumes and their tile crops from the seed, builds
the two in-memory datasets (``data.pipeline.create_dataset_from_tensors``:
augmentation, global adjust, shuffled epochs), zips them as ``EM2EM.train``
does, makes the train state (``train.create_state``) and loads the
benchmark's own seeded weights into it, then drives the first steps
through the window's own feed and step: they warm every shape, and their
losses, the first gradients (from Adam's first moment) and the parameters
after them are kept for the check.  The window runs steps, epoch after
epoch, for ``--seconds``.  Afterwards the plain reference makes the same
batches from the same crops and follows the same steps in float32.  Four
numbers are compared (``reference.train.compare``): the first step's
objective (the sum of its losses that the step minimises), the
discriminators' first gradients (the worst leaf's norm, and the worst
leaf's direction) and each leaf's change over the steps (the worst leaf).
The generators' first gradients, the 7 losses one by one and the later
steps' losses are reported beside them and not compared: the cycle and
identity losses clip ``1 - |real - fake| / 2`` at 1e-7, so the few voxels
just above the clip carry gradients up to 1/(2e-7) that rounding of the
inputs alone moves, and Adam's first steps, which move nearly every element
by the learning rate whatever its gradient's size, carry that into the
later losses (see PERF.md).

The generators' backward is held by a probe away from the losses (two more
numbers, ``reference.train.probe_compare``): two fresh generators of the
port, built as ``train.create_state`` builds them and loaded with the
set-up weights of gg and gf, each run without dropout on the first batch
that the reference pipeline makes for its domain (gg on x, gf on y), and
``torch.autograd.grad`` of the output against a seeded cotangent r
(N(0, 1) / sqrt(numel), drawn on the device from ``derive_seed(seed, 6,
k)``): dL/dθ of L = <G(x), r>, through whatever kernels and backward the
port picks for the cell's dtype, against ``reference.train.generator_probe``
in float32.  ``probe_gap_gen`` is the worst leaf's norm, by the
discriminators' rule, and ``probe_cos_gen`` the worst direction over every
leaf (the transposed convs' kernels sit under the median leaf's norm).

Cell keys: ``batch``, ``dtype``, ``volume_side``, ``elements`` (crops a
dataset), ``check_steps``, ``ref_micro`` (reference rows a block), ``gain``
(the weights' draw, ``reference.models.make_weights``), ``limits``
(objective_gap_first, grad_gap_disc, grad_cos_disc, change_gap,
probe_gap_gen, probe_cos_gen).
"""

from __future__ import annotations

import gc
import time

import torch

from benchmark import counts, inputs
from benchmark.reference import models as RM
from benchmark.reference import pipeline as RP
from benchmark.reference import train as RT

NETS = RT.NETS
CHECKS = ("objective_gap_first", "grad_gap_disc", "grad_cos_disc",
          "change_gap", "probe_gap_gen", "probe_cos_gen")


def elements(ctx):
    """The x and y datasets' uint8 tile crops."""
    c = ctx.cell
    out = []
    for k in range(2):
        vol = inputs.synth_volume(c["volume_side"],
                                  RP.derive_seed(ctx.seed, 1, k))
        out.append(inputs.crops(vol, c["elements"], 74,
                                RP.derive_seed(ctx.seed, 2, k)))
    return out


def weights(ctx, device):
    wf = ctx.config["wf"]
    g, d = RM.generator_spec(wf), RM.discriminator_spec(wf)
    return RM.make_weights([g, g, d, d], RP.derive_seed(ctx.seed, 3), device,
                           gain=ctx.cell["gain"])


def dataset_seeds(ctx):
    return RP.derive_seed(ctx.seed, 4, 0), RP.derive_seed(ctx.seed, 4, 1)


def dropout_seed(ctx) -> int:
    return RP.derive_seed(ctx.seed, 5)


def batch_of(ctx) -> int:
    """Tiles a step takes over all the cell's cards."""
    return int(ctx.cell["batch"]) * len(ctx.devices)


def port_config(ctx):
    """The port's configuration of the cell: wf, 74^3 tiles, the cell's
    dtype and batch."""
    from transfer_em_tpu_torch.config import CycleGANConfig
    return CycleGANConfig(dimsize=74, is3d=True, wf=ctx.config["wf"],
                          compute_dtype=ctx.cell["dtype"],
                          batch_size=batch_of(ctx))


def start(ctx, capture: bool = False) -> dict:
    """The system's set-up and first steps.  Returns ``one`` (a step through
    the window's feed), ``prog`` (the first steps' losses, first gradients
    and the parameters after them), ``weights`` and, with ``capture``, the
    batches the system's pipeline made for the first steps."""
    from transfer_em_tpu_torch.data.pipeline import (
        create_dataset_from_tensors, zip_datasets)
    from transfer_em_tpu_torch.device import float32_exact
    from transfer_em_tpu_torch.train import create_state, make_train_step

    float32_exact()
    dev = ctx.devices[0]
    B = batch_of(ctx)
    els_x, els_y = elements(ctx)
    sx, sy = dataset_seeds(ctx)
    common = dict(batch_size=B, enable_augmentation=True, global_adjust=True,
                  randomize=True, device=dev)
    ds_x, _ = create_dataset_from_tensors(els_x, seed=sx, **common)
    ds_y, _ = create_dataset_from_tensors(els_y, seed=sy, **common)
    config = port_config(ctx)
    state = create_state(config, 0, device=dev)
    w = weights(ctx, dev)
    for k, net in zip(NETS, w):
        getattr(state, k).load_state_dict(net, strict=True)
    step = make_train_step(config, device=dev)
    seed = dropout_seed(ctx)

    def feed():
        while True:  # epochs, as EM2EM.train runs them
            yield from zip_datasets(ds_x, ds_y)

    it = feed()
    seen = []

    def one():
        with ctx.span("data.next"):
            x, y = next(it)
        if capture and len(seen) < int(ctx.cell["check_steps"]):
            seen.append((x.clone(), y.clone()))
        with ctx.span("port.train_step"):
            return step(state, x, y, seed)

    # the first steps: warm-up, and what the check compares
    losses, first_mu = [], None
    for i in range(int(ctx.cell["check_steps"])):
        losses.append(one())
        if i == 0:
            first_mu = {k: {n: m.detach().clone() for n, m in
                            getattr(state, "opt_" + k).mu.items()}
                        for k in NETS}
    prog = {"losses": torch.stack(losses).double().cpu().numpy(),
            # Adam's first moment after one step is (1 - beta1) g
            "first_grads": {k: {n: m / (1 - config.adam_beta1)
                                for n, m in first_mu[k].items()}
                            for k in NETS},
            "params": {k: {n: p.detach().clone() for n, p in
                           getattr(state, k).named_parameters()}
                       for k in NETS}}
    return {"one": one, "prog": prog, "weights": w, "batches": seen,
            "elements": (els_x, els_y)}


def ref_batches(ctx, els, count: int):
    """The reference pipeline's first ``count`` batches of each domain from
    the crops ``els``, NCDHW on the cell's device."""
    dev, B = ctx.devices[0], batch_of(ctx)
    ref_els = [[torch.from_numpy(e).to(dev) for e in es] for es in els]
    return tuple(RP.batches(e, B, s, True, count)
                 for e, s in zip(ref_els, dataset_seeds(ctx)))


def reference(ctx, w, els, quant=None, dtype=torch.float32, batches=None):
    """The plain reference over the first steps, from ``w`` and the crops
    ``els``: it makes the batches itself unless ``batches`` ([(x, y)] in
    the system's channels-last layout) are given."""
    n = int(ctx.cell["check_steps"])
    if batches is None:
        bx, by = ref_batches(ctx, els, n)
    else:
        bx = [x.permute(0, 4, 1, 2, 3).contiguous() for x, _ in batches]
        by = [y.permute(0, 4, 1, 2, 3).contiguous() for _, y in batches]
    if dtype != torch.float32:
        w = [{k: v.to(dtype) for k, v in net.items()} for net in w]
        bx, by = [b.to(dtype) for b in bx], [b.to(dtype) for b in by]
    with RM.exact():
        return RT.run_steps(w, bx, by, dropout_seed(ctx), ctx.config["wf"],
                            micro=ctx.cell["ref_micro"], quant=quant)


def probe_inputs(ctx, els):
    """The probe's batches, the reference pipeline's first of x (for gg)
    and of y (for gf), NCDHW, and their cotangents: N(0, 1) of the
    generator's output shape over sqrt(numel), drawn on the device from
    ``derive_seed(seed, 6, k)``."""
    dev = ctx.devices[0]
    xs = [b[0] for b in ref_batches(ctx, els, 1)]
    rs = []
    for k, x in enumerate(xs):
        g = torch.Generator(device=dev).manual_seed(
            RP.derive_seed(ctx.seed, 6, k))
        shape = (x.shape[0], 1) + tuple(n - 2 * ctx.config["buffer"]
                                        for n in x.shape[2:])
        rs.append(torch.randn(shape, generator=g, device=dev)
                  / torch.Size(shape).numel() ** 0.5)
    return xs, rs


def program_probe(ctx, w, xs, rs) -> dict:
    """The probe on the system's side: two fresh generators built as
    ``train.create_state`` builds them for the cell, loaded with the
    set-up weights ``w[0]`` and ``w[1]``, each run without dropout on its
    batch (channels-last, as the step takes it), and the gradient of its
    output against r by ``torch.autograd.grad``.  Nothing here picks a
    kernel: the port's own routes for a conv that records a gradient run."""
    from transfer_em_tpu_torch.train import build_models
    dev = ctx.devices[0]
    gens = build_models(port_config(ctx),
                        generator=torch.Generator().manual_seed(0))[:2]
    out = {}
    for k, gen, net, x, r in zip(RT.GEN, gens, w, xs, rs):
        gen.to(dev).load_state_dict(net, strict=True)
        params = dict(gen.named_parameters())
        y = gen(x.permute(0, 2, 3, 4, 1).contiguous(), deterministic=True)
        out[k] = dict(zip(params, torch.autograd.grad(
            y, list(params.values()), grad_outputs=r.permute(0, 2, 3, 4, 1))))
    return out


def reference_probe(ctx, w, xs, rs, quant=None) -> dict:
    """The probe on the reference's side, in float32 (TF32 off), or under
    ``quant`` for the control."""
    with RM.exact():
        return RT.generator_probe(w[:2], xs, rs, int(ctx.cell["ref_micro"]),
                                  quant=quant)


def run(ctx, control=None):
    """One run; with ``control`` (a ``reference.models`` rounding) the
    reference in that precision takes the program's place in the checks,
    and the program's own readings go to ``detail``."""
    s = start(ctx)
    one = s["one"]
    ctx.begin_window()
    steps = 0
    end = time.perf_counter() + ctx.seconds
    while time.perf_counter() < end:
        one()
        steps += 1
    ctx.end_window()

    prog, w, els = s["prog"], s["weights"], s["elements"]
    del s, one
    gc.collect()
    if ctx.devices[0].type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    xs, rs = probe_inputs(ctx, els)
    probe = program_probe(ctx, w, xs, rs)
    ctx.sync()
    probe_s = {"program": time.perf_counter() - t}
    ref = reference(ctx, w, els)
    gaps = RT.compare(prog, ref, w)
    t = time.perf_counter()
    probe_ref = reference_probe(ctx, w, xs, rs)
    ctx.sync()
    probe_s["reference"] = time.perf_counter() - t
    gaps.update(RT.probe_compare(probe, probe_ref))
    del probe
    lim = ctx.cell["limits"]
    detail = dict(gaps, probe_s=probe_s)
    if control is not None:
        detail = {"program": {k: gaps[k] for k in CHECKS},
                  "leaves": gaps["leaves"],
                  "probe_leaves": gaps["probe_leaves"], "probe_s": probe_s}
        gaps = RT.compare(reference(ctx, w, els, quant=control), ref, w)
        gaps.update(RT.probe_compare(
            reference_probe(ctx, w, xs, rs, quant=control), probe_ref))
        detail.update({k: v for k, v in gaps.items()
                       if not k.endswith("leaves")},
                      control_leaves=gaps["leaves"],
                      control_probe_leaves=gaps["probe_leaves"])
    B, wf, dtype = batch_of(ctx), ctx.config["wf"], ctx.cell["dtype"]
    flops = counts.train_step_flops(wf, B)["total"]
    c3 = counts.conv_work(counts.train_conv3_calls(B), wf, dtype)
    return {"e2e": {"train_tiles_per_s": steps * B / ctx.window_s},
            "attempted": steps, "failed": 0,
            "checks": [(k, gaps[k], lim[k]) for k in CHECKS],
            "detail": detail,
            "obs": {"kind": "train", "steps": steps, "tiles": steps * B,
                    "dtype": dtype, "flops_per_step": flops,
                    "conv3_flops_per_step": c3["flops"],
                    "conv3_bytes_per_step": c3["bytes"]}}
