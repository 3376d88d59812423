"""The port at the model's full widths (wf=1: 64-256 channels) on the CPU,
held against the JAX package: the 3D generator and discriminator, conv3's
plain version at every wf=1 k3 shape, conv3's tile plans against the CUDA
source's ``Cfg`` at every width, the batch rule, a wf=1 export's round
trip, the kernels' 32-bit argument guard, and the two bench modules.

The JAX side runs as its own tests run it: XLA convs (its Pallas conv takes
C <= 32 only, so at wf=1 every JAX k3 conv is ``lax.conv``).  Weights and
inputs come from numpy seeds; each test states its tolerance.  The train
steps at wf=1 are in ``test_torch_full_width_train.py``.
"""

import json
import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_conv3 import _emulate_tc
from transfer_em_tpu.config import ExportMeta as JaxMeta
from transfer_em_tpu.infer.export import export_generator as jax_export
from transfer_em_tpu.infer.tiling import default_batch_size as jax_batch
from transfer_em_tpu.models import Discriminator as JaxDisc
from transfer_em_tpu.models import UNetGenerator as JaxUNet
from transfer_em_tpu.models.blocks import leaky_relu as jax_leaky
from transfer_em_tpu.ops.convs import conv_nd as jax_conv_nd
from transfer_em_tpu_torch import kernels
from transfer_em_tpu_torch.bench import infer as bench_infer
from transfer_em_tpu_torch.bench import train as bench_train
from transfer_em_tpu_torch.config import CycleGANConfig, ExportMeta
from transfer_em_tpu_torch.infer import export_generator, load_generator
from transfer_em_tpu_torch.infer.export import save_model
from transfer_em_tpu_torch.infer.tiling import default_batch_size
from transfer_em_tpu_torch.models import Discriminator, UNetGenerator
from transfer_em_tpu_torch.models.blocks import ConvND
from transfer_em_tpu_torch.models.convert import (params_from_jax,
                                                  params_geometry)
from transfer_em_tpu_torch.ops import convs, cuda_conv
from transfer_em_tpu_torch.train import EM2EM

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TC_SOURCE = os.path.join(REPO, "transfer_em_tpu_torch", "csrc",
                         "conv3_tc.cu")
WIDTHS = (1, 2, 4, 8, 16, 32)
DTYPES = (torch.float32, torch.bfloat16)

# every k3 conv at wf=1: (layer, input side, C, O), as the nets build them
# (the discriminator's hack and down3 keep the reference's fixed 16 and 32
# outputs at every width)
WF1_K3 = [("stem", 74, 1, 64), ("down1.conv", 72, 64, 64),
          ("down2.conv", 34, 64, 128), ("up1.conv", 15, 128, 256),
          ("mid", 26, 256, 256), ("up0.conv", 24, 256, 128),
          ("head", 44, 128, 128), ("out", 42, 128, 1),
          ("disc.down1.conv", 40, 1, 64), ("disc.hack", 18, 64, 16),
          ("disc.down2.conv", 16, 16, 256), ("disc.down3.conv", 6, 256, 32)]


def numpy_tree(module, seed):
    """A flax-shaped param tree for ``module``'s state_dict: kernels with
    std 1/sqrt(fan-in) (activations stay O(1) at any width), 1-D params
    N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    tree = {}
    for name, p in module.state_dict().items():
        node = tree
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        std = (0.1 if p.dim() == 1
               else float(np.prod(p.shape[:-1])) ** -0.5)
        node[leaf] = rng.normal(0, std, tuple(p.shape)).astype(np.float32)
    return {"params": tree}


def _input(seed, shape):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _on_conv3(m):
    """Whether ``ops/convs.py`` runs ConvND ``m``'s float32 conv on conv3."""
    n = m.kernel.dim() - 2
    x = torch.empty((1,) + (8,) * n + (m.kernel.shape[-2],), device="meta")
    return convs.conv_form(x, m.kernel, m.stride, m.padding) == "conv3"


def _k3_pairs(net):
    return [tuple(int(s) for s in m.kernel.shape[3:]) for m in net.modules()
            if isinstance(m, ConvND) and _on_conv3(m)]


# -- the networks --------------------------------------------------------------

def test_wf1_layer_list_is_the_nets():
    """WF1_K3 is what the modules build, in their call order."""
    with torch.device("meta"):
        pairs = _k3_pairs(UNetGenerator(wf=1)) + _k3_pairs(
            Discriminator(wf=1))
    assert pairs == [(c, o) for _, _, c, o in WF1_K3]


def test_wf1_generator_matches_jax():
    """3D wf=1, 74^3, B=1, f32, the port's plain versions against
    UNetGenerator(wf=1): atol 2e-5 (read 3.0e-6 on outputs of up to ~1;
    the two frameworks sum K = 27 * 256 products in different orders)."""
    params = numpy_tree(UNetGenerator(wf=1), seed=1)
    x = _input(3, (1, 74, 74, 74, 1))
    want = np.asarray(jax.jit(JaxUNet(wf=1).apply)(params, jnp.asarray(x)))
    gen = UNetGenerator(wf=1)
    gen.load_state_dict(params_from_jax(params))
    with torch.inference_mode():
        got = gen.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 40, 40, 40, 1)
    assert np.abs(want).max() > 0.05  # a meaningful signal
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_wf1_discriminator_matches_jax():
    """3D wf=1, 40^3, B=2, f32: atol 1e-4 (the wf=8 test's bar)."""
    disc = Discriminator(wf=1)
    params = numpy_tree(disc, seed=4)
    x = _input(5, (2, 40, 40, 40, 1))
    want = np.asarray(jax.jit(JaxDisc(is3d=True, wf=1).apply)(
        params, jnp.asarray(x)))
    disc.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        got = disc.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 1, 1, 1, 1)
    assert np.abs(want).max() > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


# -- conv3 at the wf=1 shapes --------------------------------------------------

@pytest.mark.parametrize("act", [False, True], ids=["plain", "epilogue"])
@pytest.mark.parametrize("layer,side,c,o", WF1_K3, ids=[n for n, *_ in WF1_K3])
def test_wf1_conv3_plain_matches_jax(layer, side, c, o, act):
    """conv3's plain version (the kernels' function on the CPU) at each
    wf=1 k3 shape, on a 1 x 8^3 input (6^3 out), against JAX's conv_nd
    (and its leaky_relu for the epilogue): within 1e-5 of max(1, |ref|)
    (K = 27 * C products summed in f32 in two orders)."""
    rng = np.random.default_rng(side * 1000 + c + o)
    x = rng.normal(0, 1, (1, 8, 8, 8, c)).astype(np.float32)
    w = (rng.normal(0, 1, (3, 3, 3, c, o)) / np.sqrt(27 * c)).astype(
        np.float32)
    want = jax_conv_nd(jnp.asarray(x), jnp.asarray(w))
    if act:
        want = jax_leaky(want)
    want = np.asarray(want)
    got = cuda_conv.conv3(torch.from_numpy(x), torch.from_numpy(w),
                          0.3 if act else None).numpy()
    assert got.shape == want.shape == (1, 6, 6, 6, o)
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol


def _tc_cfg(dtype, nc, cs, kw=False):
    """``Cfg<T, NC, CS>`` of csrc/conv3_tc.cu (``CfgKw<NC, CS>``, the kw
    form's, with ``kw``), evaluated from the source: the patch constants
    before it and each ``static constexpr`` of the struct, in order (C
    ternaries and integer division turned into Python), and its ``smem``
    as a function of (n_cb, resident, ring)."""
    src = open(TC_SOURCE).read()
    f32 = dtype == torch.float32
    env = {"NC": nc, "CS": cs}
    name = "CfgKw" if kw else "Cfg"

    def py(expr):
        m = re.fullmatch(r"(.+?)\s*\?\s*(.+?)\s*:\s*(.+)", expr)
        if m:  # a ternary, nested ones in its last branch
            return f"(({py(m[2])}) if ({py(m[1])}) else ({py(m[3])}))"
        expr = expr.replace("std::is_same<T, float>::value", str(f32))
        expr = expr.replace("sizeof(T)", "4" if f32 else "2")
        return expr.replace("/", "//")

    top, cfg = src.split(f"struct {name} {{", 1)
    cfg = cfg.split("\n};", 1)[0]
    for decl in re.findall(r"^constexpr int (.+);", top, re.M):
        for part in decl.split(","):
            var, expr = part.split("=", 1)
            env[var.strip()] = eval(py(expr.strip()), {}, env)
    for var, expr in re.findall(
            r"static constexpr (?:int|bool) (\w+) = ([^;]+);", cfg):
        env[var] = eval(py(expr), {}, env)
    if kw:
        smem = re.search(r"return \(ring \? kRing : kSlots\) \* kPlaneBytes "
                         r"\+\s+\(resident \? 9 \* n_cb : 6\) \* "
                         r"kStageBytes;", cfg)
        expr = ("(kRing if ring else kSlots) * kPlaneBytes"
                " + (9 * n_cb if resident else 6) * kStageBytes")
    else:
        smem = re.search(r"return (kInBytes \+ \(resident \? 9 : 2\) \* "
                         r"kStageBytes);", cfg)
        expr = "kInBytes + (9 if resident else 2) * kStageBytes"
    assert smem, f"{name}::smem changed: update this test with it"
    env["smem"] = lambda n_cb, resident, ring: eval(
        expr, {}, {**env, "n_cb": n_cb, "resident": resident, "ring": ring})
    env["nc_cases"] = {int(n) for n in re.findall(r"case (\d+):", src)}
    return env


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("wf", WIDTHS)
def test_conv3_plan_agrees_with_the_kernel_at_every_width(wf, dtype):
    """Every k3 conv of UNetGenerator(wf) and Discriminator(wf) that takes
    the tensor-core kernel: its plan fits the H100's opt-in shared memory,
    covers C and O (n_cb * cb >= C, n_chunks * nc >= O), and is what the
    kernel's ``Cfg`` (``CfgKw`` for a kw-form plan) in csrc/conv3_tc.cu
    computes for the template the launch dispatches to (CS from cb, NC
    from nc): channel block,
    planes, shared memory for the plan's residency, the channel-block and
    chunk counts, and the packed weights' bytes (n_chunks * n_cb * 9
    stages).  Pins the source's claim that any C and O of
    UNetGenerator(wf), wf 1..32, fits."""
    with torch.device("meta"):
        pairs = set(_k3_pairs(UNetGenerator(wf=wf))
                    + _k3_pairs(Discriminator(wf=wf)))
    checked = 0
    for c, o in sorted(pairs):
        if cuda_conv.conv3_path(c, o) != "tc":
            assert c < cuda_conv.TC_MIN_IN or o < cuda_conv.TC_MIN_OUT
            continue
        p = cuda_conv.conv3_plan(c, o, dtype)
        assert p.smem_bytes <= cuda_conv.SMEM_LIMIT
        assert p.n_cb * p.cb >= c and p.n_chunks * p.nc >= o
        assert p.cb in (p.kk, 2 * p.kk)  # the two CS the launch takes
        cfg = _tc_cfg(dtype, p.nc, p.cb // p.kk, p.kw)
        assert p.nc in cfg["nc_cases"]
        assert (cfg["kKK"], cfg["kCB"], cfg["kP"], cfg["kParts"]) == (
            p.kk, p.cb, p.planes, p.parts)
        assert cfg["smem"](p.n_cb, p.resident, p.ring) == p.smem_bytes
        assert -(-c // cfg["kCB"]) == p.n_cb and -(-o // p.nc) == p.n_chunks
        w = torch.empty((3, 3, 3, c, o), device="meta")
        packed = cuda_conv.pack_conv3_weights(w, dtype)
        assert packed.numel() * packed.element_size() == (
            p.n_chunks * p.n_cb * 9 * cfg["kStageBytes"])
        checked += 1
    assert checked > 0


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("c,o", [(64, 128), (128, 256), (256, 32)])
def test_wf1_packed_layout_drives_the_conv(c, o, dtype):
    """The tensor-core kernel's GEMM walked as the kernel walks it
    (test_torch_conv3._emulate_tc: every output chunk, as blockIdx.y, and
    every channel block) at wf=1 widths with several chunks (64 -> 128,
    128 -> 256) or channel blocks (256 -> 32), against the f32 conv: atol
    1e-4 (the test_torch_conv3 bar)."""
    rng = np.random.default_rng(c + o)
    x = torch.from_numpy(rng.normal(0, 1, (1, 4, 4, 5, c)).astype(
        np.float32)).to(dtype)
    w = torch.from_numpy((rng.normal(0, 1, (3, 3, 3, c, o))
                          / np.sqrt(27 * c)).astype(np.float32)).to(dtype)
    plan = cuda_conv.conv3_plan(c, o, dtype)
    assert plan.n_chunks > 1 or plan.n_cb > 2
    got = _emulate_tc(x, cuda_conv.pack_conv3_weights(w, dtype), plan)
    want = torch.nn.functional.conv3d(
        x.float().permute(0, 4, 1, 2, 3),
        w.float().permute(4, 3, 0, 1, 2)).permute(0, 2, 3, 4, 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-4)


def test_kernel_int_arguments_past_32_bits_raise():
    """A kernel's ``int`` argument past 32 bits raises before any launch
    (ctypes would pass it wrapped); element counts cross as ``long long``,
    so a tensor past 2^31 elements (a wf=1 stem activation at B=128:
    128 * 72^3 * 64 = 3.06e9) goes through."""
    n = 128 * 72 ** 3 * 64
    assert n > 2 ** 31
    kernels.check_c_ints("tem_leaky_relu", (0, 0, 0, n, 0.3))
    kernels.check_c_ints("tem_preprocess_u8", (0, 0, n, 1.0, 0.0))
    ok = (0, 0, 0, 0, 128, 74, 74, 74, 1, 64, 0, 0.3)
    kernels.check_c_ints("tem_conv3_direct", ok)
    for bad in (2 ** 31, -2 ** 31 - 1):
        args = ok[:4] + (bad,) + ok[5:]
        with pytest.raises(ValueError, match="argument 4"):
            kernels.check_c_ints("tem_conv3_direct", args)
    with pytest.raises(ValueError, match="32-bit"):
        kernels.launch("tem_conv3_direct", *args, device=torch.device("cpu"))


# -- the batch rule, the export ------------------------------------------------

@pytest.mark.parametrize("wf", WIDTHS)
def test_default_batch_size_matches_jax(wf):
    """The port's default_batch_size is the JAX package's rule at every
    width (wf=8 -> 128, wf=1 -> 16)."""
    with torch.device("meta"):
        gen = UNetGenerator(wf=wf)
    shapes = jax.eval_shape(JaxUNet(wf=wf).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 74, 74, 74, 1)))
    assert default_batch_size(gen) == jax_batch(shapes)
    assert default_batch_size(gen) == {1: 16, 2: 32, 4: 64}.get(wf, 128)


@pytest.mark.parametrize("is3d", [True, False], ids=["3d", "2d"])
def test_wf1_jax_export_loads_in_the_port(tmp_path, is3d):
    """A wf=1 generator exported by the JAX package (msgpack) loads in the
    port as wf=1, 3D or 2D as exported, with its parameters bit-equal;
    params_geometry reads (wf, is3d) off the weights alone."""
    tmpl = UNetGenerator(wf=1, is3d=is3d)
    params = numpy_tree(tmpl, seed=6)
    meta = JaxMeta(buffer=17, outdimsize=40, meanstd_x=(0.1, 0.9),
                   meanstd_y=(-0.2, 0.7), is3d=is3d, wf=1)
    jax_export(jax.tree.map(jnp.asarray, params), meta, str(tmp_path))
    gen, got_meta = load_generator(str(tmp_path), device="cpu")
    want = params_from_jax(params)
    assert (gen.wf, gen.is3d, got_meta.wf, got_meta.is3d) == (1, is3d, 1,
                                                              is3d)
    assert params_geometry(want) == (1, is3d)
    sd = gen.state_dict()
    assert set(sd) == set(want)
    assert all(torch.equal(sd[k], want[k]) for k in want)


def test_wf1_em2em_checkpoint_save_model_load(tmp_path):
    """EM2EM(74, wf=1) -> make_checkpoint -> save_model(wf=1) ->
    load_generator: a wf=1 3D generator equal to the model's G, bit for
    bit, whose weights alone read as wf=1 3D (params_geometry)."""
    model = EM2EM(74, "wf1", wf=1, checkpoint_root=str(tmp_path),
                  device="cpu")
    model.make_checkpoint(1)
    model.wait_until_finished()
    out = str(tmp_path / "export")
    save_model(out, os.path.join(model.checkpoint_path, "1"), (0.1, 0.9),
               (-0.2, 0.7), 74, wf=1, device="cpu")
    gen, meta = load_generator(out, device="cpu")
    assert (gen.wf, meta.wf, gen.is3d) == (1, 1, True)
    assert params_geometry(gen.state_dict()) == (1, True)
    want = model.state.gg.state_dict()
    assert all(torch.equal(v, want[k]) for k, v in gen.state_dict().items())


# -- the bench modules ---------------------------------------------------------

def test_flop_count_equals_a_hand_count():
    """bench.train counts each conv kind as a hand count does, at wf=16 on
    a 74^3 tile: the stem (k3, 1 -> 4, 72^3 out), down1.down (k4 s2,
    4 -> 4, 34^3 out), up1.up (transposed, 16 -> 8, 13^3 in) and the
    discriminator's head (1x1, 32 -> 16, 1 voxel); and a step's total is
    6 forwards of each network, every generator's dw and dx but round 1's
    stem dx, and the discriminators' dw on 4 applications and dx on all
    but the trained ones' first layer."""
    gen = {r["name"]: r for r in bench_train.conv_layers(
        lambda: UNetGenerator(wf=16), (1, 74, 74, 74, 1))}
    disc = {r["name"]: r for r in bench_train.conv_layers(
        lambda: Discriminator(wf=16), (1, 40, 40, 40, 1))}
    assert gen["stem"]["kind"] == "k3"
    assert gen["stem"]["macs"] == 72 ** 3 * 27 * 1 * 4
    assert gen["down1.down"]["kind"] == "k4_down"
    assert gen["down1.down"]["macs"] == 34 ** 3 * 64 * 4 * 4
    assert gen["up1.up"]["kind"] == "transposed"
    assert gen["up1.up"]["macs"] == 13 ** 3 * 64 * 16 * 8
    assert disc["head"]["kind"] == "1x1"
    assert disc["head"]["macs"] == 1 * 1 * 32 * 16
    b = 3
    f = bench_train.step_flops(CycleGANConfig(wf=16), b)
    g = sum(r["macs"] for r in gen.values())
    d = sum(r["macs"] for r in disc.values())
    first = disc["down1.conv"]["macs"]
    want = 2 * b * (6 * g + 6 * d                                 # forward
                    + 6 * g + 4 * d                               # dw
                    + 6 * g - 4 * gen["stem"]["macs"] + 6 * d - 4 * first)
    assert f["total"] == want and f["per_tile_pair"] == want / b
    assert sum(f["by_kind"].values()) == want
    remat = bench_train.step_flops(CycleGANConfig(wf=16, remat=True), b)
    assert remat["total"] == want + 2 * b * 6 * g


def test_flop_count_at_wf1_is_near_jax_accounting():
    """At wf=1 the port's count per tile pair, 5.08 TF, sits within 1% of
    the JAX package's 5.1 (bench_wf1.py's accounting); k3 convs are 81%
    of it."""
    f = bench_train.step_flops(CycleGANConfig(wf=1), 1)
    assert abs(f["per_tile_pair"] / 5.1e12 - 1) < 0.01
    assert 0.80 < f["by_kind"]["k3"] / f["total"] < 0.82


def test_bench_train_prints_one_json_line(capsys):
    """python -m transfer_em_tpu_torch.bench.train at wf=16, B=1, 2 steps
    on the CPU: one JSON line with the step's numbers and FLOPs, and no
    share of the card's peak (the CPU is not the card)."""
    assert bench_train.main(["--wf", "16", "--batch", "1", "--steps", "2",
                             "--dtype", "f32", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    for key in ("config", "wf", "dtype", "batch", "step_s", "tiles_per_s",
                "median_step_s_2_to_n", "peak_memory_gb", "flops_per_step",
                "flops_per_tile_pair", "flops_by_kind", "tflops_per_s",
                "share_of_peak", "device", "card", "losses_finite"):
        assert key in rec, key
    assert rec["device"] == "cpu" and rec["share_of_peak"] is None
    assert rec["losses_finite"] and len(rec["step_s"]) == 2
    assert rec["flops_per_step"] == bench_train.step_flops(
        CycleGANConfig(wf=16), 1)["total"]
    assert math.isclose(rec["tiles_per_s"],
                        1 / rec["median_step_s_2_to_n"])


def test_bench_train_sweep_reports_oom_and_goes_on(monkeypatch):
    """--sweep runs bench_wf1.py's configs in its order; one that runs out
    of device memory is reported (oom) and skipped, the next still runs."""
    seen = []

    def fake(wf, dtype, steps, device, batch, accum=1, remat=False):
        seen.append(bench_train.config_tag(batch, accum, remat))
        if batch == 10:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory.")
        return {"config": seen[-1]}

    monkeypatch.setattr(bench_train, "measure", fake)
    lines = []
    out = bench_train.sweep(device="cpu", emit=lines.append)
    assert seen == ["B=8", "B=8 remat", "B=16 accum=2", "B=10", "B=12",
                    "B=12 remat", "B=24 accum=2"]
    assert out[3]["oom"] and out[3]["config"] == "B=10"
    assert [json.loads(s)["config"] for s in lines] == seen


def test_bench_infer_prints_one_json_line(capsys):
    """python -m transfer_em_tpu_torch.bench.infer at wf=16 on the CPU over
    an 80^3 volume (a 40^3 request, 8 tiles): one JSON line, device and
    slab Mvox/s, the copies timed apart; device mode's output equals
    predict_volume's on the same seeded generator and volume."""
    assert bench_infer.main(["--wf", "16", "--dtype", "f32", "--side", "80",
                             "--reps", "1", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["device"] == "cpu" and rec["batch"] == 128
    assert rec["size"] == [40, 40, 40] and set(rec["modes"]) == {"device",
                                                                 "slab"}
    for m in rec["modes"].values():
        assert m["mvox_per_s"] > 0 and len(m["s"]) == 1
    assert rec["upload_s"] is not None and rec["download_s"] is not None
    assert rec["best"]["mode"] in rec["modes"]
    assert rec["output_std"] > 2  # the seeded weights spread the levels
