"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return ``torch.device(device)``; raise if CUDA is asked for but absent.

    The port never carries on quietly on the CPU: the CPU runs only when the
    caller names it (``device="cpu"``, as the tests do)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} asked for (the default), but "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "run the plain PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    return dev


def float32_exact() -> None:
    """TF32 off for cuDNN's convs and cuBLAS's products, so the port's
    float32 path is float32 (conv3's float32 kernel keeps f32 accuracy as
    3xTF32 either way).  The model service's ``main``, the benches and
    ``chip_smoke.py`` set it before their first call."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
