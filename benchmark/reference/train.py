"""Plain CycleGAN train step of janelia-flyem/transfer_em (cgan.py:144-228):
four generator applications (G and F on the real x and y tiles together,
then the two cycles), the discriminators on the real and the detached fake
tiles, and frozen on the fakes for the generators' adversarial terms; the
focal losses; one backward of their sum, the cycle term counted once; four
Keras Adam updates (lr 2e-4, beta1 0.5, eps 1e-7 on the uncorrected
sqrt(v), the bias correction folded into the step size in float32).

The step runs in row blocks of ``micro`` tiles so that a full-width batch
fits beside nothing else: every loss is a mean over tiles, so the block's
loss weighted by its share of the batch adds up to the batch's, and so do
the gradients.  Dropout bytes are drawn for the whole application (2B rows
in the first round, B in the cycles) from a generator on the batch's device
seeded with ``derive_seed(seed, step, application)``, and each block takes
its rows.

Beside the step, :func:`generator_probe` takes the generators' gradients
of a smooth scalar, <generator(x), r> for a given cotangent r, which the
losses' clip cannot reach (:func:`probe_compare`).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from . import models as M
from .pipeline import derive_seed

K_EPSILON = 1e-7
ALPHA, GAMMA = 0.5, 2.0  # the focal losses' (Keras's defaults)
NETS = ("gg", "gf", "dx", "dy")


def _abs(x):
    return torch.where(x >= 0, x, -x)


def focal(labels, preds, from_logits: bool):
    """Sigmoid focal cross-entropy, summed over the channel axis (1), mean
    over the rest."""
    zero = preds.new_zeros(())
    if from_logits:
        ce = (torch.maximum(preds, zero) - preds * labels
              + torch.log1p(torch.exp(-_abs(preds))))
        p = torch.sigmoid(preds)
    else:
        pc = torch.minimum(torch.maximum(preds, zero + K_EPSILON),
                           zero + (1.0 - K_EPSILON))
        ce = -(labels * torch.log(pc + K_EPSILON)
               + (1.0 - labels) * torch.log(1.0 - pc + K_EPSILON))
        p = preds
    p_t = labels * p + (1.0 - labels) * (1.0 - p)
    alpha_t = labels * ALPHA + (1.0 - labels) * (1.0 - ALPHA)
    return torch.mean(torch.sum(alpha_t * torch.pow(1.0 - p_t, GAMMA) * ce,
                                dim=1))


def gen_adv(d_fake):
    return focal(torch.ones_like(d_fake), d_fake, True) * 2.0


def disc_loss(d_real, d_fake):
    return (focal(torch.ones_like(d_real), d_real, True) * 2.0
            + focal(torch.zeros_like(d_fake), d_fake, True) * 2.0) * 0.5


def tconf(real, other):
    t = 1.0 - _abs(real - other) / 2.0
    return focal(torch.ones_like(t), t, False) * 2.0


class Adam:
    lr, b1, b2, eps = 2e-4, 0.5, 0.999, 1e-7

    def step_size(self, count: int) -> float:
        f = np.float32
        c, one = f(count), f(1.0)
        return float(f(self.lr) * np.sqrt(one - f(self.b2) ** c)
                     / (one - f(self.b1) ** c))

    def update(self, params, grads, m, v, count):
        lr_t = self.step_size(count)
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k]
                m[k].mul_(self.b1).add_(g * (1 - self.b1))
                v[k].mul_(self.b2).add_(g * (1 - self.b2) * g)
                p.add_(m[k] * -lr_t / (v[k].sqrt() + self.eps))


def _pad(x, n):
    return F.pad(x, (n,) * 6)


def step_losses(nets: Dict[str, Dict[str, torch.Tensor]], rx, ry, masks,
                rows, B: int, wf: int, quant=None):
    """The combined scalar and the 7 losses [g_total, f_total, disc_y,
    disc_x, g_adv, f_adv, cycle] of the tiles ``rows`` (an index into the
    batch); ``masks[a]`` the full-batch dropout bytes of application a."""
    buf = 17
    gg, gf, dx, dy = (nets[k] for k in NETS)
    r1 = torch.cat([rows, rows + B])

    def sel(a, r):
        return tuple(m[r] for m in masks[a])

    x, y = rx[rows], ry[rows]
    n = len(rows)
    out_g = M.generator(gg, torch.cat([x, y]), sel(0, r1), quant)
    fake_y, same_y = out_g[:n], out_g[n:]
    out_f = M.generator(gf, torch.cat([y, x]), sel(1, r1), quant)
    fake_x, same_x = out_f[:n], out_f[n:]
    cyc_y = M.generator(gg, _pad(fake_x, buf), sel(2, rows), quant)
    cyc_x = M.generator(gf, _pad(fake_y, buf), sel(3, rows), quant)
    xc, yc = M.crop(x, buf), M.crop(y, buf)
    ox = M.discriminator(dx, torch.cat([xc, fake_x.detach()]), quant)
    oy = M.discriminator(dy, torch.cat([yc, fake_y.detach()]), quant)
    frozen = {k: {n_: p.detach() for n_, p in nets[k].items()}
              for k in ("dx", "dy")}
    dfx = M.discriminator(frozen["dx"], fake_x, quant)
    dfy = M.discriminator(frozen["dy"], fake_y, quant)
    g_adv, f_adv = gen_adv(dfy), gen_adv(dfx)
    cycle = (2.0 * tconf(M.crop(x, 2 * buf), M.crop(cyc_x, buf))
             + 2.0 * tconf(M.crop(y, 2 * buf), M.crop(cyc_y, buf)))
    id_y = 2.0 * 0.5 * tconf(yc, same_y)
    id_x = 2.0 * 0.5 * tconf(xc, same_x)
    dxl = disc_loss(ox[:n], ox[n:])
    dyl = disc_loss(oy[:n], oy[n:])
    combined = g_adv + f_adv + cycle + id_y + id_x + dxl + dyl
    vec = torch.stack([g_adv + cycle + id_y, f_adv + cycle + id_x, dyl, dxl,
                       g_adv, f_adv, cycle]).detach()
    return combined, vec


def run_steps(weights: Sequence[Dict[str, torch.Tensor]],
              batches_x: Sequence[torch.Tensor],
              batches_y: Sequence[torch.Tensor], seed: int, wf: int,
              micro: int, quant=None) -> dict:
    """Train from ``weights`` (gg, gf, dx, dy; copied) over the batches
    (NCDHW, on one device), one step a pair.  Returns each step's 7 losses
    (float64 numpy), every leaf's first gradient and the parameters after
    the last step."""
    device = batches_x[0].device
    nets = {k: {n: w.detach().clone().to(device).requires_grad_(True)
                for n, w in net.items()} for k, net in zip(NETS, weights)}
    opt = Adam()
    m = {k: {n: torch.zeros_like(p) for n, p in nets[k].items()}
         for k in NETS}
    v = {k: {n: torch.zeros_like(p) for n, p in nets[k].items()}
         for k in NETS}
    losses, first_grads = [], None
    for step, (rx, ry) in enumerate(zip(batches_x, batches_y)):
        B = rx.shape[0]
        masks = []
        for app in range(4):
            g = torch.Generator(device=device).manual_seed(
                derive_seed(seed, step, app))
            masks.append(M.draw_masks(g, 2 * B if app < 2 else B,
                                      rx.shape[2], wf, device))
        grads = {k: {n: torch.zeros_like(p) for n, p in nets[k].items()}
                 for k in NETS}
        vec = torch.zeros(7, dtype=torch.float64, device=device)
        for s in range(0, B, micro):
            rows = torch.arange(s, min(s + micro, B), device=device)
            w = len(rows) / B
            combined, lv = step_losses(nets, rx, ry, masks, rows, B, wf,
                                       quant)
            params = [p for k in NETS for p in nets[k].values()]
            gs = torch.autograd.grad(combined * w, params, allow_unused=True)
            i = 0
            for k in NETS:
                for n in nets[k]:
                    if gs[i] is not None:
                        grads[k][n] += gs[i]
                    i += 1
            vec += lv.double() * w
        if first_grads is None:
            first_grads = {k: {n: g.clone() for n, g in grads[k].items()}
                           for k in NETS}
        for k in NETS:
            opt.update(nets[k], grads[k], m[k], v[k], step + 1)
        losses.append(vec.cpu().numpy())
    return {"losses": np.stack(losses), "first_grads": first_grads,
            "params": {k: {n: p.detach() for n, p in nets[k].items()}
                       for k in NETS}}


def objective(losses) -> float:
    """The scalar a step minimises, from its 7 losses: both adversarial
    terms, the cycle term once, both identity terms, both discriminator
    losses."""
    g_tot, f_tot, d_y, d_x, _, _, cycle = (float(v) for v in losses)
    return g_tot + f_tot - cycle + d_y + d_x


EXCLUDE_BELOW = 1e-3  # of the median leaf's first gradient
DISC = ("dx", "dy")
GEN = ("gg", "gf")


def _norms(grads, nets) -> Dict[tuple, float]:
    return {(k, n): float(g.double().norm())
            for k in nets for n, g in grads[k].items()}


def _cosines(a, b, keep) -> Dict[tuple, float]:
    """cos(g_a, g_b) of each leaf in ``keep``; 0 where either is zero."""
    out = {}
    for k, n in keep:
        x = a[k][n].detach().double().to(b[k][n].device)
        y = b[k][n].detach().double()
        d = float(x.norm() * y.norm())
        out[(k, n)] = float((x * y).sum()) / d if d > 0 else 0.0
    return out


def _worst(got: Dict[tuple, float], want: Dict[tuple, float], keep):
    """The largest | got - want | / max(want, the median of ``want`` over
    ``keep``), and its leaf."""
    med = float(np.median([want[kn] for kn in keep]))
    gap, worst = 0.0, None
    for kn in keep:
        g = abs(got[kn] - want[kn]) / max(want[kn], med)
        if g > gap:
            gap, worst = g, kn
    return gap, (".".join(worst) if worst else None), med


def group_gaps(prog_grads, ref_grads, nets) -> dict:
    """Gradients of the networks ``nets``, program against reference, leaf
    by leaf: ``gap``, the largest | |g| - |g_ref| | over max(|g_ref| of the
    leaf, the group's median leaf norm), and ``cos``, over the leaves whose
    reference norm is at or above the median's, the largest
    1 - cos(g, g_ref) (a smaller leaf's direction follows rounding; its
    norm's gap is ``gap``'s), each with its leaf.  Leaves whose reference
    norm is under ``EXCLUDE_BELOW`` of the median are left out; ``keep``
    lists the rest.  ``cos_all`` (and ``cos_all_leaf``) is the largest
    1 - cos over every kept leaf; ``cosines`` holds each kept leaf's
    cosine."""
    gref, gp = _norms(ref_grads, nets), _norms(prog_grads, nets)
    med = float(np.median(list(gref.values())))
    keep = [kn for kn in gref if gref[kn] >= EXCLUDE_BELOW * med]
    gap, gap_leaf, _ = _worst(gp, gref, keep)
    cos = _cosines(prog_grads, ref_grads, keep)
    worst = min((kn for kn in keep if gref[kn] >= med), key=cos.get)
    worst_all = min(keep, key=cos.get)
    return {"gap": gap, "gap_leaf": gap_leaf, "cos": 1.0 - cos[worst],
            "cos_leaf": ".".join(worst), "cos_all": 1.0 - cos[worst_all],
            "cos_all_leaf": ".".join(worst_all), "keep": keep,
            "median": med, "norms": gp, "norms_ref": gref, "cosines": cos}


def compare(prog: dict, ref: dict,
            init: Sequence[Dict[str, torch.Tensor]]) -> dict:
    """The train cell's numbers, program against reference:

    * ``objective_gap_first``: |J - J_ref| / |J_ref| of the first step's
      objective J (:func:`objective`);
    * ``grad_gap_disc`` / ``grad_cos_disc``: :func:`group_gaps`' ``gap``
      and ``cos`` of the discriminators' first gradients;
      ``grad_gap_gen`` / ``grad_cos_gen`` the same of the generators', and
      ``grad_gap`` of all leaves (reported only: the cycle and identity
      losses' clip makes the generators' first gradients follow rounding;
      :func:`probe_compare` holds their backward);
    * ``change_gap``: over every leaf, the same of the leaf's change over
      the steps, against the median leaf's change;
    * ``loss_gap``: the largest |loss - ref| / |ref| over the steps' 7
      losses (``loss_gap_first``: the first step's; reported only).

    ``prog`` holds the same keys as :func:`run_steps` returns.  Leaves
    whose reference gradient is under ``EXCLUDE_BELOW`` of the median of
    their group's are left out of that group's gaps and of the change's
    (round-off moves them under Adam); they are listed under
    ``excluded``."""
    lp, lr = np.asarray(prog["losses"], np.float64), ref["losses"]
    by_step = np.max(np.abs(lp - lr) / np.maximum(np.abs(lr), 1e-12), axis=1)
    op, orf = objective(lp[0]), objective(lr[0])
    out, groups = {}, {}
    for key, nets in (("grad_gap", NETS), ("grad_gap_disc", DISC),
                      ("grad_gap_gen", GEN)):
        g = groups[key] = group_gaps(prog["first_grads"], ref["first_grads"],
                                     nets)
        out[key] = g["gap"]
        out["worst_" + key.replace("grad_gap", "grad") + "_leaf"] = g[
            "gap_leaf"]
    for key in ("disc", "gen"):
        g = groups["grad_gap_" + key]
        out["grad_cos_" + key] = g["cos"]
        out["worst_grad_cos_%s_leaf" % key] = g["cos_leaf"]
    everything = groups["grad_gap"]
    keep_all, gp, gref = (everything["keep"], everything["norms"],
                          everything["norms_ref"])
    disc = groups["grad_gap_disc"]
    cos = {kn: c for kn, c in disc["cosines"].items()
           if disc["norms_ref"][kn] >= disc["median"]}
    init_by = dict(zip(NETS, init))

    def change(params):
        return {(k, n): float((params[k][n].detach().double()
                               .to(init_by[k][n].device)
                               - init_by[k][n].double()).norm())
                for k, n in keep_all}
    dprog, dref = change(prog["params"]), change(ref["params"])
    out["change_gap"], out["worst_change_leaf"], dmed = _worst(
        dprog, dref, keep_all)
    leaves = {".".join(kn): [gp[kn], gref[kn], dprog[kn], dref[kn]]
              for kn in keep_all}
    for kn, c in cos.items():
        if kn in keep_all:
            leaves[".".join(kn)].append(c)
    return dict(out, objective_gap_first=abs(op - orf) / max(abs(orf), 1e-12),
                loss_gap=float(by_step.max()), leaves=leaves,
                median_grad=float(np.median([gref[kn] for kn in keep_all])),
                median_change=dmed, loss_gap_first=float(by_step[0]),
                loss_gap_by_step=by_step.tolist(), losses=lp.tolist(),
                losses_ref=lr.tolist(),
                excluded=[".".join(kn) for kn in gref if kn not in keep_all])


def generator_probe(weights: Sequence[Dict[str, torch.Tensor]],
                    xs: Sequence[torch.Tensor], rs: Sequence[torch.Tensor],
                    micro: int, quant=None) -> Dict[str, Dict[str,
                                                               torch.Tensor]]:
    """The generators' backward away from the losses: for each generator
    (``weights``, gg then gf), its batch (``xs``, NCDHW) and a cotangent of
    its output's shape (``rs``), dL/dθ of the smooth scalar
    L = <generator(x), r>, without dropout, in blocks of ``micro`` tiles
    whose leaf gradients are summed.  The backward is linear in r, so every
    conv's backward is exercised with no clip in the way."""
    out = {}
    for k, w, x, r in zip(GEN, weights, xs, rs):
        p = {n: t.detach().clone().to(x.device).requires_grad_(True)
             for n, t in w.items()}
        grads = {n: torch.zeros_like(t) for n, t in p.items()}
        for s in range(0, x.shape[0], micro):
            y = M.generator(p, x[s:s + micro], quant=quant)
            gs = torch.autograd.grad(y, list(p.values()),
                                     grad_outputs=r[s:s + micro])
            for n, g in zip(p, gs):
                grads[n] += g
            del y, gs
        out[k] = grads
    return out


def probe_compare(prog: dict, ref: dict) -> dict:
    """The probe's numbers (:func:`generator_probe`'s gradients, program
    against reference; both ``{"gg": {leaf: grad}, "gf": {..}}``) over both
    generators' leaves (:func:`group_gaps`): ``probe_gap_gen``, the worst
    leaf's norm, by ``grad_gap_disc``'s rule; ``probe_cos_gen``, the
    largest 1 - cos(g, g_ref) over every kept leaf.  Unlike the step's
    gradients, no leaf's direction here follows rounding more than the
    others' (the leaves under the median read as the rest on the card), so
    a direction fault in a small leaf, such as a transposed conv's kernel,
    is caught too; the discriminators' rule, over the leaves at or above
    the median, is reported as ``probe_cos_gen_top``."""
    g = group_gaps(prog, ref, GEN)
    leaves = {".".join(kn): [g["norms"][kn], g["norms_ref"][kn],
                             g["cosines"][kn]] for kn in g["keep"]}
    return {"probe_gap_gen": g["gap"], "worst_probe_gap_leaf": g["gap_leaf"],
            "probe_cos_gen": g["cos_all"],
            "worst_probe_cos_leaf": g["cos_all_leaf"],
            "probe_cos_gen_top": g["cos"], "probe_median_grad": g["median"],
            "probe_leaves": leaves,
            "probe_excluded": [".".join(kn) for kn in g["norms_ref"]
                               if kn not in g["keep"]]}
