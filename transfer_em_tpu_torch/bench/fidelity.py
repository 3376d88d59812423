"""Output fidelity of the port against the frozen TF reference: the
counterpart of the JAX package's ``bench_fidelity.py``.

    python -m transfer_em_tpu_torch.bench.fidelity [--goldens DIR]
        [--dtype f32[,bf16]] [--wf1] [--device cuda]

The four golden fixtures (``tests/goldens/{gen,disc}_{2d,3d}.npz``: the
reference's weights in build order, an input and the reference's output,
captured once from janelia-flyem/transfer_em with TF) are read with numpy
from ``--goldens`` (default: the repo's ``tests/goldens``), loaded into the
port's generator and discriminator (wf=8) and run on ``--device``.  One
JSON line a dtype: ``golden_psnr_db_min``, the minimum PSNR over the four,
with ``vs_baseline`` = value / 40 dB (the fidelity bar; >= 1 passes), each
fixture's PSNR, and the kernels' launches.  The discriminators run in
float32 in every line (the JAX bench has no bf16 discriminator).

``--wf1``: the fixtures are wf=8 only, so, as the JAX bench's ``--wf1``
does, the full-width generator (wf=1, 2D and 3D, a seeded uniform input
and weights drawn from ``torch.Generator().manual_seed(0)``) is held
against itself at the device's default precision: its float32 output on
the device against the plain PyTorch versions in float32 on the CPU
(``gen_{2d,3d}_wf1_self``, in each dtype's line).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List

import numpy as np
import torch

from . import (DTYPES, card, emit, float32_exact, launch_counts, launches,
               log, psnr)
from ..device import resolve_device
from ..models import Discriminator, UNetGenerator
from ..models.convert import (DISC_ORDER_2D, DISC_ORDER_3D, GEN_ORDER,
                              params_from_tf_order)

PSNR_BAR_DB = 40.0
DEFAULT_GOLDENS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "tests", "goldens")


def _run(module: torch.nn.Module, x: np.ndarray, dev) -> np.ndarray:
    module = module.to(dev).eval()
    with torch.inference_mode():
        return module(torch.from_numpy(x).to(dev)).float().cpu().numpy()


def golden_psnr(goldens: str, dtype: str, dev) -> Dict[str, float]:
    """PSNR (dB) of each fixture through the port at ``dtype`` (the
    generators'; the discriminators run in float32)."""
    out = {}
    for tag in ("2d", "3d"):
        data = np.load(os.path.join(goldens, f"gen_{tag}.npz"))
        gen = UNetGenerator(wf=8, compute_dtype=DTYPES[dtype],
                            is3d=tag == "3d")
        gen.load_state_dict(params_from_tf_order(data, GEN_ORDER))
        out[f"gen_{tag}"] = psnr(_run(gen, data["x"], dev), data["y"])
        data = np.load(os.path.join(goldens, f"disc_{tag}.npz"))
        disc = Discriminator(wf=8, is3d=tag == "3d")
        disc.load_state_dict(params_from_tf_order(
            data, DISC_ORDER_3D if tag == "3d" else DISC_ORDER_2D))
        out[f"disc_{tag}"] = psnr(_run(disc, data["x"], dev), data["y"])
    return out


def wf1_self(dev) -> Dict[str, float]:
    """The wf=1 generator on ``dev`` in float32 (the port's default
    precision: TF32 off, conv3's float32 kernel) against the plain
    versions in float32 on the CPU, same weights and input."""
    rng = np.random.default_rng(3)
    out = {}
    for tag, shape in (("2d", (1, 74, 74, 1)), ("3d", (1, 74, 74, 74, 1))):
        x = rng.uniform(-1, 1, size=shape).astype(np.float32)
        gen = UNetGenerator(wf=1, is3d=tag == "3d",
                            generator=torch.Generator().manual_seed(0))
        want = _run(gen, x, torch.device("cpu"))
        out[f"gen_{tag}_wf1_self"] = psnr(_run(gen, x, dev), want)
    return out


def measure(goldens: str = DEFAULT_GOLDENS, dtype: str = "f32",
            device="cuda", extra: Dict[str, float] = None) -> dict:
    """The line of one dtype; ``extra``: more PSNRs to fold into its
    minimum (:func:`wf1_self`'s)."""
    dev = resolve_device(device)
    before = launch_counts()
    results = golden_psnr(goldens, dtype, dev)
    results.update(extra or {})
    for name, value in sorted(results.items()):
        log(f"# {name}: {value:.2f} dB on {dev} ({DTYPES[dtype]})")
    worst = min(results.values())
    return {"bench": "fidelity", "metric": "golden_psnr_db_min",
            "value": worst, "unit": "dB",
            "vs_baseline": worst / PSNR_BAR_DB, "dtype": DTYPES[dtype],
            "psnr_db": results, "goldens": os.path.abspath(goldens),
            "launches": launches(before), **card(dev)}


def main(argv: List[str] = None) -> int:
    ap = argparse.ArgumentParser(
        description="golden PSNR of the port (one JSON line a dtype).")
    ap.add_argument("--goldens", default=DEFAULT_GOLDENS,
                    help="directory of the golden .npz fixtures")
    ap.add_argument("--dtype", default="f32",
                    help="comma-separated: f32, bf16")
    ap.add_argument("--wf1", action="store_true",
                    help="also the wf=1 generator against the CPU's plain "
                         "float32 forward")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    float32_exact()
    dtypes = [d for d in args.dtype.split(",") if d]
    unknown = set(dtypes) - set(DTYPES)
    if unknown:
        ap.error(f"unknown dtype(s) {sorted(unknown)}: f32, bf16")
    extra = wf1_self(resolve_device(args.device)) if args.wf1 else None
    for dtype in dtypes:
        emit(measure(args.goldens, dtype, args.device, extra))
    return 0


if __name__ == "__main__":
    sys.exit(main())
