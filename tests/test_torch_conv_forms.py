"""The route table: which form runs each conv of the wf=8 generator and
discriminator, 3D and 2D, in every mode the port runs them in.

A conv runs in one of five forms (``ops/convs.py``'s module docstring):
``conv3`` (the k3 stride-1 kernel), ``down4`` (the k4 stride-2 down
kernel), ``phase`` (a transposed conv as the phase conv on conv3),
``cudnn`` (``torch.nn.functional``'s conv or transposed conv, cuDNN on the
card) or ``int8`` (the int8 conv kernel).  The forms are recorded where
they run, beneath any routing code: conv3's forward body, down4's and the
int8 conv's plain versions (what the CPU runs for each kernel), and the
library's conv functions called from anywhere else.  The table below is
written out by hand; every change to a route changes it."""

import contextlib

import pytest
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from transfer_em_tpu_torch.models import Discriminator, UNetGenerator
from transfer_em_tpu_torch.models.blocks import ConvND, ConvTransposeND
from transfer_em_tpu_torch.ops import cuda_conv, cuda_down, cuda_int8

torch.set_num_threads(1)

_LIBRARY = frozenset({F.conv2d, F.conv3d, F.conv_transpose2d,
                      F.conv_transpose3d})

GEN = ("stem", "down1.conv", "down1.down", "down2.conv", "down2.down",
       "up1.conv", "up1.up", "mid", "up0.conv", "up0.up", "head", "out")
DISC3 = ("down1.conv", "down1.down", "hack", "down2.conv", "down2.down",
         "down3.conv", "down3.down", "head", "out")
DISC2 = DISC3[2:]

# (net, spatial rank, mode) -> the form of each conv, in call order.  The
# k4 down convs take down4 and the up convs the phase conv only in 3D
# float32 inference (the discriminator's down2 and down3 outputs are too
# small for down4); the k3 stride-1 convs take conv3 in 3D in every float
# mode; the 1x1 convs and every 2D float conv take the library's.
FORMS = {
    ("gen", 3, "f32_inference"):
        "conv3 conv3 down4 conv3 down4 conv3 phase conv3 conv3 phase conv3 "
        "conv3",
    ("gen", 3, "f32_grad"):
        "conv3 conv3 cudnn conv3 cudnn conv3 cudnn conv3 conv3 cudnn conv3 "
        "conv3",
    ("gen", 3, "bf16"):
        "conv3 conv3 cudnn conv3 cudnn conv3 cudnn conv3 conv3 cudnn conv3 "
        "conv3",
    ("gen", 3, "vmap"):
        "conv3 conv3 cudnn conv3 cudnn conv3 cudnn conv3 conv3 cudnn conv3 "
        "conv3",
    ("gen", 3, "int8"): " ".join(["int8"] * 12),
    ("disc", 3, "f32_inference"):
        "conv3 down4 conv3 conv3 cudnn conv3 cudnn cudnn cudnn",
    ("disc", 3, "f32_grad"):
        "conv3 cudnn conv3 conv3 cudnn conv3 cudnn cudnn cudnn",
    ("disc", 3, "bf16"):
        "conv3 cudnn conv3 conv3 cudnn conv3 cudnn cudnn cudnn",
    ("disc", 3, "vmap"):
        "conv3 cudnn conv3 conv3 cudnn conv3 cudnn cudnn cudnn",
    ("gen", 2, "f32_inference"): " ".join(["cudnn"] * 12),
    ("gen", 2, "f32_grad"): " ".join(["cudnn"] * 12),
    ("gen", 2, "bf16"): " ".join(["cudnn"] * 12),
    ("gen", 2, "vmap"): " ".join(["cudnn"] * 12),
    ("gen", 2, "int8"): " ".join(["int8"] * 12),
    ("disc", 2, "f32_inference"): " ".join(["cudnn"] * 7),
    ("disc", 2, "f32_grad"): " ".join(["cudnn"] * 7),
    ("disc", 2, "bf16"): " ".join(["cudnn"] * 7),
    ("disc", 2, "vmap"): " ".join(["cudnn"] * 7),
}


class _Recorder(TorchFunctionMode):
    """Files each form that runs under the conv module being called."""

    def __init__(self):
        super().__init__()
        self.modules = []  # the conv modules open, innermost last
        self.forms = {}    # module name -> forms in call order
        self.inside = False  # in a recorded form, whose convs are its own

    def note(self, form):
        if self.modules:
            self.forms.setdefault(self.modules[-1], []).append(form)

    def leaf(self, form, fn):
        def run(*args, **kwargs):
            self.note(form)
            self.inside = True
            try:
                return fn(*args, **kwargs)
            finally:
                self.inside = False
        return run

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in _LIBRARY and not self.inside:
            self.note("cudnn")
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def recorded(net, monkeypatch):
    rec = _Recorder()

    def leave(*_):
        rec.modules.pop()

    handles = []
    for name, m in net.named_modules():
        if isinstance(m, (ConvND, ConvTransposeND)):
            handles.append(m.register_forward_pre_hook(
                lambda _m, _a, name=name: rec.modules.append(name)))
            handles.append(m.register_forward_hook(leave))
    monkeypatch.setattr(cuda_conv, "_conv3",
                        rec.leaf("conv3", cuda_conv._conv3))
    monkeypatch.setattr(cuda_down, "down4_plain",
                        rec.leaf("down4", cuda_down.down4_plain))
    monkeypatch.setattr(cuda_int8, "conv_int8_plain",
                        rec.leaf("int8", cuda_int8.conv_int8_plain))
    try:
        with rec:
            yield rec.forms
    finally:
        for h in handles:
            h.remove()


def _form(module, forms):
    """One module's form: its recorded forms agree (a vmapped conv3 runs
    once a stacked network), and a transposed conv on conv3 is the phase
    conv."""
    assert len(set(forms)) == 1, forms
    form = forms[0]
    if isinstance(module, ConvTransposeND) and form == "conv3":
        return "phase"
    return form


def _net(kind, rank, mode):
    g = torch.Generator().manual_seed(3)
    kw = {"wf": 8, "is3d": rank == 3, "generator": g}
    if mode == "bf16":
        kw["compute_dtype"] = "bfloat16"
    if kind == "gen":
        return UNetGenerator(int8_conv=mode == "int8", **kw).eval(), 74
    return Discriminator(**kw).eval(), 40


def _run(net, x, mode):
    if mode in ("f32_inference", "bf16", "int8"):
        with torch.inference_mode():
            return net(x)
    if mode == "f32_grad":
        return net(x)
    params = torch.func.stack_module_state([net, net])
    with torch.no_grad():
        return torch.func.vmap(
            lambda p, b: torch.func.functional_call(net, (p, b), (x,)))(
                *params)


@pytest.mark.parametrize("kind,rank,mode", list(FORMS),
                         ids=["-".join(map(str, k)) for k in FORMS])
def test_route_table(kind, rank, mode, monkeypatch):
    net, side = _net(kind, rank, mode)
    x = torch.randn((1,) + (side,) * rank + (1,),
                    generator=torch.Generator().manual_seed(4))
    with recorded(net, monkeypatch) as forms:
        _run(net, x, mode)
    modules = dict(net.named_modules())
    got = [_form(modules[n], forms[n]) for n in forms]
    names = GEN if kind == "gen" else (DISC3 if rank == 3 else DISC2)
    assert list(forms) == list(names)
    assert " ".join(got) == FORMS[(kind, rank, mode)]
