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


def compare(prog: dict, ref: dict,
            init: Sequence[Dict[str, torch.Tensor]]) -> dict:
    """The train cell's numbers, program against reference:

    * ``objective_gap_first``: |J - J_ref| / |J_ref| of the first step's
      objective J (:func:`objective`);
    * ``grad_gap_disc``: over the discriminators' leaves, | |g| - |g_ref| |
      of the first gradient, over max(|g_ref| of the leaf, the median of
      the discriminators' leaves); ``grad_gap_gen`` the same over the
      generators' leaves and ``grad_gap`` over all (reported only);
    * ``grad_cos_disc``: over the discriminators' leaves whose reference
      norm is at or above their median leaf's, the largest
      1 - cos(g, g_ref) of the first gradient (a smaller leaf's direction
      follows rounding; its norm's gap is ``grad_gap_disc``'s);
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
    gref = _norms(ref["first_grads"], NETS)
    gp = _norms(prog["first_grads"], NETS)
    out, keep_all = {}, set()
    for key, nets in (("grad_gap", NETS), ("grad_gap_disc", DISC),
                      ("grad_gap_gen", ("gg", "gf"))):
        group = [kn for kn in gref if kn[0] in nets]
        med = float(np.median([gref[kn] for kn in group]))
        keep = [kn for kn in group if gref[kn] >= EXCLUDE_BELOW * med]
        leaf = "worst_" + key.replace("grad_gap", "grad") + "_leaf"
        out[key], out[leaf], _ = _worst(gp, gref, keep)
        if key == "grad_gap":
            keep_all = keep
        if key == "grad_gap_disc":
            cos = _cosines(prog["first_grads"], ref["first_grads"],
                           [kn for kn in keep if gref[kn] >= med])
            worst = min(cos, key=cos.get)
            out["grad_cos_disc"] = 1.0 - cos[worst]
            out["worst_grad_cos_disc_leaf"] = ".".join(worst)
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
