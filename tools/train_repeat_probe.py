"""Does a train step repeat bit for bit on the card, and does a restored
state continue as the uninterrupted one does?

    python3 tools/train_repeat_probe.py

A one-off reading behind PERF.md's note on repeatability; no path or test
of the port runs it.  At the default config (3D, wf=8, 74^3, float32,
dropout on) and B=16, a state takes 2 steps and is snapshotted
(``train/checkpoints.snapshot``); then 2 more steps run from it on the
same seeded batches in each of these ways:

* ``continued``: the state itself, uninterrupted;
* ``restored_a`` / ``restored_b``: a fresh state with the snapshot written
  in (``load_into``), twice;
* ``poisoned_nan``: restored after the caching allocator's free blocks
  were filled with NaN and released, so a kernel that reads memory it did
  not write gives NaN or another result.

It prints one JSON line per way: whether its two losses equal
``continued``'s, and after each step how many tensors (parameters, their
gradients, Adam moments) differ from ``continued``'s, the largest first.
Then the same under ``torch.backends.cudnn.deterministic`` from the first
step on: whether an uninterrupted state and a restored one end bit-equal,
and whether two restored runs do; the median time of a step in each mode;
then the card's nvidia-smi line.  Needs one CUDA card.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from transfer_em_tpu_torch.config import CycleGANConfig  # noqa: E402
from transfer_em_tpu_torch.models.convert import TREES  # noqa: E402
from transfer_em_tpu_torch.train import (create_state,  # noqa: E402
                                         make_train_step)
from transfer_em_tpu_torch.train.checkpoints import (load_into,  # noqa: E402
                                                     snapshot)

B, SEED = 16, 0


@contextlib.contextmanager
def cudnn_deterministic(on: bool):
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = on
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def _record(st):
    """Every parameter, its gradient and its Adam moments, by name, on the
    host."""
    out = {}
    for t in TREES:
        net, opt = getattr(st, t), getattr(st, "opt_" + t)
        for k, p in net.named_parameters():
            out[f"{t}.{k}"] = p.detach().cpu().clone()
            out[f"{t}.{k}.grad"] = p.grad.detach().cpu().clone()
            out[f"{t}.{k}.mu"] = opt.mu[k].cpu().clone()
            out[f"{t}.{k}.nu"] = opt.nu[k].cpu().clone()
    return out


def _differing(a, b):
    return sorted(((k, float((a[k] - b[k]).abs().max())) for k in a
                   if not torch.equal(a[k], b[k])), key=lambda kv: -kv[1])


def _poison_nan(dev) -> None:
    """Fill free device memory the allocator hands out next (a large block
    and many small ones) with NaN, then release it to the allocator."""
    free = torch.cuda.mem_get_info(dev)[0]
    big = torch.full((int(free * 0.6) // 4,), float("nan"), device=dev)
    small = [torch.full((1 << 17,), float("nan"), device=dev)
             for _ in range(400)]
    torch.cuda.synchronize()
    del big, small


def main():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = CycleGANConfig(wf=8)
    g = torch.Generator(device=dev).manual_seed(3)
    batches = [(0.3 * torch.randn((B, 74, 74, 74, 1), generator=g, device=dev),
                0.3 * torch.randn((B, 74, 74, 74, 1), generator=g, device=dev))
               for _ in range(4)]
    step = make_train_step(cfg, device=dev)
    step_s = {False: [], True: []}

    def run(st, deterministic=False):
        """Steps 3 and 4: their losses and the state after each."""
        losses, recs = [], []
        with cudnn_deterministic(deterministic):
            for x, y in batches[2:]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append(step(st, x, y, SEED).cpu())
                step_s[deterministic].append(time.perf_counter() - t0)
                recs.append(_record(st))
        return losses, recs

    def trained(deterministic=False):
        st = create_state(cfg, SEED, dev)
        with cudnn_deterministic(deterministic):
            for x, y in batches[:2]:
                step(st, x, y, SEED)
        return st

    def restored(snap):
        st = create_state(cfg, SEED, dev)
        load_into(st, snap)
        return st

    state = trained()
    snap = snapshot(state)
    results = {"continued": run(state)}
    results["restored_a"] = run(restored(snap))
    results["restored_b"] = run(restored(snap))
    _poison_nan(dev)
    results["poisoned_nan"] = run(restored(snap))
    ref_losses, ref = results["continued"]
    for name, (losses, recs) in results.items():
        line = {"way": name, "losses_equal": [
            bool(torch.equal(a, b)) for a, b in zip(losses, ref_losses)],
            "losses_finite": all(bool(torch.isfinite(lv).all())
                                 for lv in losses)}
        for i, (rec, rref) in enumerate(zip(recs, ref)):
            d = _differing(rec, rref)
            line[f"step{i + 3}_differing"] = f"{len(d)} of {len(rec)}"
            line[f"step{i + 3}_largest"] = d[:4]
        print(json.dumps(line), flush=True)

    state = trained(deterministic=True)
    snap = snapshot(state)
    cont = run(state, deterministic=True)[1][-1]
    rest_a = run(restored(snap), deterministic=True)[1][-1]
    rest_b = run(restored(snap), deterministic=True)[1][-1]
    print(json.dumps({
        "cudnn_deterministic": True,
        "continued_equals_restored": not _differing(cont, rest_a),
        "restored_repeat_equal": not _differing(rest_a, rest_b),
        "differing_continued_vs_restored": len(_differing(cont, rest_a)),
        "median_step_s": {"default": statistics.median(step_s[False]),
                          "deterministic": statistics.median(step_s[True])},
        "batch": B}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
