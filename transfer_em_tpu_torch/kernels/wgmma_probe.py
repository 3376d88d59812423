"""Measure the tensor cores' wgmma rate at the conv's output widths.

    python3 -m transfer_em_tpu_torch.kernels.wgmma_probe

Builds ``csrc/probe/wgmma_rate.cu`` with nvcc (sm_90a) into ``_build/``
and prints one JSON line per (N, dtype): the rate in TFLOP/s (TOP/s for
int8) of wgmma with A from registers (tf32, bf16 and s8), issued the way
``csrc/conv3_tc.cu`` and ``csrc/conv_int8.cu`` issue it (4 tiles per
warpgroup, 2 at N = 64 and 96, 1 at 192, at most one commit group in
flight behind the newest), with 4 warpgroups on each SM: N = 8-64 for
every dtype, and for tf32 also the widths of conv3's kw form (N = 3 * O:
24, 48, 96, and 192 for its hi and lo weights side by side).  Then one
line per k-step pattern of the kw form (``kstep``): the three 3xTF32
products as three wgmmas of width N, or as one of width 2N (x_hi times
[w_hi | w_lo]) and one of width N, counted at the plain products' FLOPs.
Then the card's nvidia-smi line.  The rate at the conv's N (8-32 at
wf=8) is what its products can reach; the published peaks assume large
N.  Needs one CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess

import torch

from . import BUILD_DIR, CSRC_DIR, NVCC_FLAGS, _nvcc

SOURCE = os.path.join(CSRC_DIR, "probe", "wgmma_rate.cu")
LIB = os.path.join(BUILD_DIR, "libtem_wgmma_probe.so")
K_DEPTH = {"tf32": 8, "bf16": 16, "s8": 32}
DTYPES = ("tf32", "bf16", "s8")


def build() -> ctypes.CDLL:
    os.makedirs(BUILD_DIR, exist_ok=True)
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", LIB, SOURCE],
                   check=True)
    lib = ctypes.CDLL(LIB)
    lib.tem_wgmma_rate.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.tem_wgmma_rate.restype = ctypes.c_int
    lib.tem_wgmma_kstep.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.tem_wgmma_kstep.restype = ctypes.c_int
    return lib


TILES = {64: 2, 96: 2, 192: 1}  # tiles a warpgroup keeps, else 4
TF32_ONLY = (24, 48, 96, 192)
# (N, pair, tiles): the kw form's k-step patterns
KSTEPS = ((24, 0, 4), (24, 1, 4), (24, 1, 2), (48, 0, 4), (48, 0, 2),
          (48, 1, 2), (96, 0, 2), (96, 1, 1))


def _timed(fn) -> float:
    """ms of the second of two launches of fn (the first warms up)."""
    for _ in range(2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        code = fn()
        end.record()
        torch.cuda.synchronize()
        if code != 0:
            raise RuntimeError(f"wgmma probe: CUDA error {code}")
    return start.elapsed_time(end)


def rate(lib, n: int, dtype: str, iters: int = 4000) -> dict:
    """TFLOP/s (TOP/s for s8) of the dense products, timed with CUDA
    events."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = 4 * sms
    tiles = TILES.get(n, 4)
    out = torch.empty(blocks * 128, device="cuda")
    args = (n, DTYPES.index(dtype), blocks, iters, out.data_ptr())
    ms = _timed(lambda: lib.tem_wgmma_rate(*args))
    flops = 2.0 * 64 * n * K_DEPTH[dtype] * tiles * iters * blocks
    return {"n": n, "dtype": dtype, "tiles_per_warpgroup": tiles,
            "warpgroups": blocks, "ms": ms, "tflops": flops / ms / 1e9}


def kstep(lib, n: int, pair: int, tiles: int, iters: int = 4000) -> dict:
    """TFLOP/s of the kw form's f32 k-step at width n on ``tiles`` tiles a
    warpgroup, counted as the three products' plain FLOPs (3 x 64 x n x 8
    multiply-adds a tile a step)."""
    blocks = 4 * torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(blocks * 128, device="cuda")
    ms = _timed(lambda: lib.tem_wgmma_kstep(n, pair, tiles, blocks, iters,
                                            out.data_ptr()))
    flops = 3 * 2.0 * 64 * n * 8 * tiles * iters * blocks
    return {"kstep": n, "pattern": "2n+n" if pair else "3 x n",
            "tiles_per_warpgroup": tiles, "warpgroups": blocks, "ms": ms,
            "tflops": flops / ms / 1e9}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("wgmma_probe needs a CUDA card")
    lib = build()
    for dtype in DTYPES:
        for n in (8, 16, 32, 64) + (TF32_ONLY if dtype == "tf32" else ()):
            print(json.dumps(rate(lib, n, dtype)), flush=True)
    for n, pair, tiles in KSTEPS:
        print(json.dumps(kstep(lib, n, pair, tiles)), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False)
    print(smi.stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
