"""Measure the tensor cores' wgmma rate at the conv's output widths.

    python3 -m transfer_em_tpu_torch.kernels.wgmma_probe

Builds ``csrc/probe/wgmma_rate.cu`` with nvcc (sm_90a) into ``_build/``
and prints one JSON line per (N, dtype): the rate in TFLOP/s (TOP/s for
int8) of wgmma with A from registers (tf32, bf16 and s8), issued the way
``csrc/conv3_tc.cu`` and ``csrc/conv_int8.cu`` issue it (4 tiles per
warpgroup, 2 at N = 64, at most one commit group in flight behind the
newest), with 4 warpgroups on each SM.  Then the card's nvidia-smi line.
The rate at the conv's N (8-32 at wf=8) is what its products can reach;
the published peaks assume large N.  Needs one CUDA card.
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
    return lib


def rate(lib, n: int, dtype: str, iters: int = 4000) -> dict:
    """TFLOP/s (TOP/s for s8) of the dense products, timed with CUDA
    events."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = 4 * sms
    tiles = 2 if n == 64 else 4
    out = torch.empty(blocks * 128, device="cuda")
    args = (n, DTYPES.index(dtype), blocks, iters, out.data_ptr())
    for _ in range(2):  # warm-up, then the timed launch
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        code = lib.tem_wgmma_rate(*args)
        end.record()
        torch.cuda.synchronize()
        if code != 0:
            raise RuntimeError(f"tem_wgmma_rate: CUDA error {code}")
    ms = start.elapsed_time(end)
    flops = 2.0 * 64 * n * K_DEPTH[dtype] * tiles * iters * blocks
    return {"n": n, "dtype": dtype, "tiles_per_warpgroup": tiles,
            "warpgroups": blocks, "ms": ms, "tflops": flops / ms / 1e9}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("wgmma_probe needs a CUDA card")
    lib = build()
    for dtype in DTYPES:
        for n in (8, 16, 32, 64):
            print(json.dumps(rate(lib, n, dtype)), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False)
    print(smi.stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
