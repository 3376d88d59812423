"""Time cuDNN's float32 conv gradients at the train step's shapes, by layout.

    python3 tools/conv3_backward_probe.py

A one-off reading behind PERF.md's training breakdown; no path or test of
the port runs it.  The train step's conv gradients
(``transfer_em_tpu_torch/ops/cuda_conv.py`` conv3_backward, and
autograd's for the k4 down convs and the transposed convs) run on cuDNN in
float32 (TF32 off).  cuDNN picks its engines by the tensors' memory layout
and, with ``torch.backends.cudnn.benchmark``, by trying them.  For every
conv of the wf=8 generator and discriminator at the batch round 1 of the
step gives it (2 x 64 tiles), this prints one JSON line with the time of
``aten::convolution_backward`` (input and weight gradients) for the
activations channels-last (the NDHWC tensors permuted, as the port holds
them) and made contiguous NCDHW first (the copies included), each with
benchmark off and on, then the card's nvidia-smi line.  Needs one CUDA card.
"""

from __future__ import annotations

import json
import subprocess

import torch

# (name, input NDHWC, kernel (k, k, k, Cin, Cout), stride, transposed)
B = 128
SHAPES = [
    ("gen.stem", (B, 74, 74, 74, 1), (3, 3, 3, 1, 8), 1, False),
    ("gen.down1.conv", (B, 72, 72, 72, 8), (3, 3, 3, 8, 8), 1, False),
    ("gen.down1.down", (B, 70, 70, 70, 8), (4, 4, 4, 8, 8), 2, False),
    ("gen.down2.conv", (B, 34, 34, 34, 8), (3, 3, 3, 8, 16), 1, False),
    ("gen.down2.down", (B, 32, 32, 32, 16), (4, 4, 4, 16, 16), 2, False),
    ("gen.up1.conv", (B, 15, 15, 15, 16), (3, 3, 3, 16, 32), 1, False),
    ("gen.up1.up", (B, 13, 13, 13, 32), (4, 4, 4, 32, 16), 2, True),
    ("gen.mid", (B, 26, 26, 26, 32), (3, 3, 3, 32, 32), 1, False),
    ("gen.up0.conv", (B, 24, 24, 24, 32), (3, 3, 3, 32, 16), 1, False),
    ("gen.up0.up", (B, 22, 22, 22, 16), (4, 4, 4, 16, 8), 2, True),
    ("gen.head", (B, 44, 44, 44, 16), (3, 3, 3, 16, 16), 1, False),
    ("gen.out", (B, 42, 42, 42, 16), (3, 3, 3, 16, 1), 1, False),
    ("disc.down1.conv", (B, 40, 40, 40, 1), (3, 3, 3, 1, 8), 1, False),
    ("disc.hack", (B, 18, 18, 18, 8), (3, 3, 3, 8, 16), 1, False),
    ("disc.down2.conv", (B, 16, 16, 16, 16), (3, 3, 3, 16, 32), 1, False),
    ("disc.down3.conv", (B, 6, 6, 6, 32), (3, 3, 3, 32, 32), 1, False),
]


def _grads(x, w, g, stride, transposed, contiguous):
    """Input and weight gradients of one conv, as the port's callers hand
    the tensors over: NDHWC activations permuted to NCDHW views, or those
    views made contiguous first."""
    xc, gc = x.permute(0, 4, 1, 2, 3), g.permute(0, 4, 1, 2, 3)
    wc = w.permute(3, 4, 0, 1, 2) if transposed else w.permute(4, 3, 0, 1, 2)
    if contiguous:
        xc, gc, wc = xc.contiguous(), gc.contiguous(), wc.contiguous()
    pad = 1 if transposed else 0
    return torch.ops.aten.convolution_backward(
        gc, xc, wc, None, [stride] * 3, [pad] * 3, [1] * 3, transposed,
        [0] * 3, 1, [True, True, False])


def time_grads(name, x_shape, w_shape, stride, transposed, reps=3):
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(x_shape, generator=gen, device="cuda")
    w = torch.randn(w_shape, generator=gen, device="cuda")
    k = w_shape[0]
    if transposed:
        out = tuple(2 * s for s in x_shape[1:4])
    else:
        out = tuple((s - k) // stride + 1 for s in x_shape[1:4])
    g = torch.randn((x_shape[0],) + out + (w_shape[-1],), generator=gen,
                    device="cuda")
    rec = {"name": name, "input": list(x_shape), "kernel": list(w_shape),
           "stride": stride, "transposed": transposed}
    saved = torch.backends.cudnn.benchmark
    for bench in (False, True):
        torch.backends.cudnn.benchmark = bench
        for contiguous in (False, True):
            run = lambda: _grads(x, w, g, stride, transposed, contiguous)
            run()  # warm-up (and, with benchmark on, the engine search)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                run()
            end.record()
            torch.cuda.synchronize()
            key = (("contiguous" if contiguous else "channels_last")
                   + ("_benchmark" if bench else ""))
            rec[key + "_ms"] = start.elapsed_time(end) / reps
    torch.backends.cudnn.benchmark = saved
    return rec


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("conv3_backward_probe needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for shape in SHAPES:
        print(json.dumps(time_grads(*shape)), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False)
    print(smi.stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
