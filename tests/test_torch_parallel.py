"""The port's data and halo parallelism (``transfer_em_tpu_torch.parallel``
and every ``mesh=``) on meshes of repeated CPU devices, against the JAX
package on its eight simulated CPU devices and against the port's own
single-device paths.

* ``halo_predict`` (3D and 2D; z, z x y, z x y x x; batched over 'data';
  an awkward extent under auto_pad) against JAX's ``halo_predict`` at
  wf=32 with weights of std 1/sqrt(fan-in): rtol 1e-4, atol 1e-5.  Both
  packages run the generator on each shard's extended block, so both
  differ from one generator pass over the whole padded volume in the last
  planes before each interior slab boundary (the TF-SAME transposed convs'
  edges); at the JAX tests' N(0, 0.02) init the outputs are small enough
  for that pass to meet the same bar, which is checked as JAX checks it.
* The DP step (dropout off) against JAX's DP step with
  tests/test_torch_train_step.py's tolerances (losses rtol 1e-4, each
  network's gradients within 1e-3 of its largest |g|); the DP step and
  ``EM2EM.to_mesh`` against the single-device step (losses rtol 2e-4,
  parameters rtol 2e-3), with dropout on and with ``accum_steps=2``;
  meshed checkpoints across mesh shapes; ``make_scan_train_step(mesh=)``.
* Every inference ``mesh=`` path bit-equal to ``mesh=None`` at the same
  batch a device (on the CPU a conv's sums depend on the batch), and
  within one level of JAX's mesh path.
"""

import dataclasses
import gzip
import json
import os
import urllib.request
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transfer_em_tpu.config import CycleGANConfig as JaxConfig
from transfer_em_tpu.infer import predict_volume as jpredict_volume
from transfer_em_tpu.infer.batcher import make_tile_batcher as jbatcher
from transfer_em_tpu.infer.device_stitch import \
    device_predict_tiled as jdevice_predict_tiled
from transfer_em_tpu.infer.tiling import predict_tiled as jpredict_tiled
from transfer_em_tpu.models import UNetGenerator as JaxUNet
from transfer_em_tpu.native import gather_blocks as jgather
from transfer_em_tpu.parallel import halo_predict as jhalo_predict
from transfer_em_tpu.parallel import make_mesh as jmake_mesh
from transfer_em_tpu.parallel.mesh import batch_sharding as jbatch_sharding
from transfer_em_tpu.parallel.mesh import replicated as jreplicated
from transfer_em_tpu.train import create_state as jax_create_state
from transfer_em_tpu.train.cgan import build_models as jax_build_models
from transfer_em_tpu.train.cgan import build_step_fn as jax_build_step_fn
from transfer_em_tpu.train.cgan import cyclegan_losses as jax_losses
from transfer_em_tpu_torch.config import CycleGANConfig, ExportMeta
from transfer_em_tpu_torch.infer import (device_predict_tiled,
                                         export_generator, make_tile_batcher,
                                         predict_tiled, predict_volume)
from transfer_em_tpu_torch.infer.tiling import tile_batch
from transfer_em_tpu_torch.models import UNetGenerator
from transfer_em_tpu_torch.models.blocks import RowDraw, _keep_mask
from transfer_em_tpu_torch.models.convert import (TREES, load_jax_state,
                                                  params_from_jax)
from transfer_em_tpu_torch.native import gather_blocks
from transfer_em_tpu_torch.ops.convs import zero_pad
from transfer_em_tpu_torch.parallel import (batch_sharding,
                                            halo_predict, host_local_batch,
                                            make_dp_train_step, make_mesh,
                                            replicated, shard_batch,
                                            shard_state, space_sharding)
from transfer_em_tpu_torch.parallel.halo import (_padded_extent,
                                                 halo_predict_fn)
from transfer_em_tpu_torch.parallel.mesh import Mesh, replicas
from transfer_em_tpu_torch.serve import (ModelService, NumpyVolume,
                                         register_volume)
from transfer_em_tpu_torch.shapes import generator_shapes
from transfer_em_tpu_torch.train import (EM2EM, create_state,
                                         make_scan_train_step,
                                         make_train_step)

torch.set_num_threads(1)

CPU = torch.device("cpu")
BUFFER = generator_shapes(74).buffer  # 17
MS_X, MS_Y = (0.1, 0.9), (0.05, 1.1)


def cpus(n):
    return [CPU] * n


def fanin_scaled(params):
    """Flax params with every kernel at std 1/sqrt(fan-in) (from the N(0,
    0.02) init), so outputs are O(1) and a wrong voxel shows."""
    return jax.tree.map(
        lambda w: np.asarray(w) * (np.prod(w.shape[:-1]) ** -0.5 / 0.02),
        params)


@pytest.fixture(scope="module")
def model3d():
    jgen = JaxUNet(wf=32)
    params = fanin_scaled(jax.jit(jgen.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 74, 74, 74, 1))))
    gen = UNetGenerator(wf=32)
    gen.load_state_dict(params_from_jax(params))
    return jgen, params, gen.eval()


@pytest.fixture(scope="module")
def model2d():
    jgen = JaxUNet(wf=32)
    params = fanin_scaled(jax.jit(jgen.init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 74, 74, 1))))
    gen = UNetGenerator(wf=32, is3d=False)
    gen.load_state_dict(params_from_jax(params))
    return jgen, params, gen.eval()


# -- meshes -------------------------------------------------------------------

def test_make_mesh_validation():
    with pytest.raises(ValueError):
        make_mesh(8, data=3, space=2, devices=cpus(8))  # 6 != 8
    m = make_mesh(8, data=2, space=4, devices=cpus(8))
    assert m.shape == {"data": 2, "space": 4} and m.size == 8
    m2 = make_mesh(4, devices=cpus(8))
    assert m2.shape["data"] == 4 and m2.shape["space"] == 1
    m3 = make_mesh(devices=cpus(8), data=1, space=2, space_y=2, space_x=2)
    assert m3.axis_names == ("data", "space", "space_y", "space_x")
    assert m3.local_positions() == list(range(8))
    assert not m3.spans_processes
    assert m.axis_devices("data") == [CPU, CPU]


def test_shardings_split_and_copy():
    """batch_sharding splits axis 0 over every mesh axis, host_local_batch
    assembles the same pieces from this process's rows, replicated copies,
    space_sharding splits the leading spatial axis over 'space'."""
    mesh = make_mesh(devices=cpus(4), data=2, space=2)
    x = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    st = batch_sharding(mesh, x)
    assert st.shape == (8, 3) and st.complete
    assert [s.index[0] for s in st.addressable_shards] == [
        slice(2 * i, 2 * i + 2) for i in range(4)]
    assert torch.equal(st.gather(CPU), x)
    hl = host_local_batch(x, mesh)
    assert all(torch.equal(a.data, b.data) for a, b in
               zip(hl.addressable_shards, st.addressable_shards))
    assert torch.equal(shard_batch(x.numpy(), mesh).gather(CPU), x)
    assert all(torch.equal(r, x) for r in replicated(mesh, x))
    vol = torch.arange(4 * 5, dtype=torch.float32).reshape(4, 5, 1)
    sp = space_sharding(mesh, vol, 2)
    assert [s.index[0] for s in sp.addressable_shards] == [
        slice(0, 2), slice(2, 4)] * 2
    assert torch.equal(sp.gather(CPU), vol)
    with pytest.raises(ValueError, match="divisible"):
        batch_sharding(mesh, x[:6])


def test_replicas_made_once_and_refreshed_on_change():
    """mesh.replicas: the module itself on its own device, one copy a
    other device made once, its parameters copied in place only after the
    module's changed (the version counter conv3's pack cache keys on)."""
    net = torch.nn.Linear(3, 2)
    meta = torch.device("meta")
    home, a, b = replicas(net, [CPU, meta, meta])
    assert home is net and a is b and a.weight.device == meta
    assert replicas(net, [meta])[0] is a and a.weight._version == 0
    with torch.no_grad():
        net.weight.add_(1.0)
    assert replicas(net, [meta])[0] is a and a.weight._version == 1
    assert replicas(net, [meta])[0].weight._version == 1
    other = torch.nn.Linear(3, 2)
    with torch.inference_mode():  # a copy made here stays refreshable
        c, = replicas(other, [meta])
    assert not c.weight.is_inference()
    with torch.no_grad():
        other.weight.add_(1.0)
    assert replicas(other, [meta])[0].weight._version == 1


# -- halo_predict -------------------------------------------------------------

# (mesh kwargs, input shape, halo kwargs, 2D?)
HALO_CASES = {
    "z": (dict(data=2, space=4), (160, 74, 74, 1), {}, False),
    "z_awkward": (dict(data=2, space=4), (147, 74, 74, 1), {}, False),
    "zy": (dict(data=1, space=4, space_y=2), (80, 40, 74, 1),
           dict(y_axis="space_y"), False),
    "zyx": (dict(data=1, space=2, space_y=2, space_x=2), (40, 40, 40, 1),
            dict(y_axis="space_y", x_axis="space_x"), False),
    "batched_data": (dict(data=2, space=4), (2, 160, 74, 74, 1),
                     dict(batched=True, data_axis="data"), False),
    "batched_zy": (dict(data=2, space=2, space_y=2), (2, 40, 40, 74, 1),
                   dict(batched=True, data_axis="data", y_axis="space_y"),
                   False),
    "2d": (dict(data=2, space=4), (160, 74, 1), {}, True),
}


@pytest.mark.parametrize("case", list(HALO_CASES))
def test_halo_predict_matches_jax(case, model3d, model2d):
    mesh_kw, shape, kw, is2d = HALO_CASES[case]
    jgen, params, gen = model2d if is2d else model3d
    vol = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    want = np.asarray(jhalo_predict(lambda p, b: jgen.apply(p, b), params,
                                    jnp.asarray(vol), jmake_mesh(8, **mesh_kw),
                                    BUFFER, **kw))
    got = halo_predict(gen, None, vol, make_mesh(devices=cpus(8), **mesh_kw),
                       BUFFER, **kw)
    assert isinstance(got, torch.Tensor) and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_halo_predict_is_the_generator_on_each_extended_slab(model3d):
    """The exchange delivers exactly the zero-padded volume's planes: each
    shard's output is bit-equal to the generator run on that shard's slab
    of the padded volume; and at the JAX tests' init the whole-volume pass
    meets their bar (tests/test_parallel.py:91-113)."""
    _, _, gen = model3d
    vol = torch.from_numpy(np.random.default_rng(4).normal(
        size=(160, 74, 74, 1)).astype(np.float32))
    mesh = make_mesh(devices=cpus(4), data=1, space=4)
    got = halo_predict(gen, None, vol, mesh, BUFFER)
    padded = zero_pad(vol[None], BUFFER)[:, :, BUFFER:-BUFFER,
                                         BUFFER:-BUFFER]
    with torch.no_grad():
        slabs = torch.cat([gen(padded[:, 40 * i:40 * i + 74])[0]
                           for i in range(4)])
    assert torch.equal(got, slabs)

    small = UNetGenerator(wf=32, generator=torch.Generator().manual_seed(0))
    got = halo_predict(small, None, vol, mesh, BUFFER)
    with torch.no_grad():
        want = small(padded)[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5)
    # a callable with explicit params, as the JAX signature takes them
    from torch.func import functional_call
    params = dict(small.named_parameters())
    again = halo_predict(lambda p, b: functional_call(small, p, (b,)),
                         params, vol, mesh, BUFFER)
    assert torch.equal(again, got)


def test_halo_predict_validation(model3d):
    _, _, gen = model3d
    mesh = make_mesh(devices=cpus(8), data=2, space=4)
    with pytest.raises(ValueError, match="pooling phase"):
        halo_predict_fn(gen, mesh, 17, 4 * 18, 4)
    with pytest.raises(ValueError, match="exceed halo"):
        halo_predict_fn(gen, mesh, 17, 4 * 16, 4)
    with pytest.raises(ValueError, match="data_axis requires"):
        halo_predict_fn(gen, mesh, 17, 4 * 40, 4, data_axis="data")
    flat = Mesh(np.array(cpus(8), dtype=object), ("data",))
    with pytest.raises(ValueError, match="'space' axis"):
        halo_predict(gen, None, torch.zeros((160, 74, 74, 1)), flat, 17)
    with pytest.raises(ValueError, match="n_space"):
        halo_predict_fn(gen, mesh, 17, 8 * 40, 8)
    assert halo_predict_fn(gen, mesh, 17, 4 * 40) is not None
    with pytest.raises(ValueError, match="space_y"):
        halo_predict_fn(gen, mesh, 17, 4 * 40, 4, y_axis="space_y",
                        y_extent=40)
    mesh3 = make_mesh(devices=cpus(8), data=1, space=4, space_y=2)
    with pytest.raises(ValueError, match="y_extent"):
        halo_predict_fn(gen, mesh3, 17, 4 * 20, 4, y_axis="space_y")
    with pytest.raises(ValueError, match="y slab"):
        halo_predict_fn(gen, mesh3, 17, 4 * 20, 4, y_axis="space_y",
                        y_extent=2 * 16)
    with pytest.raises(ValueError, match="x_axis requires y_axis"):
        halo_predict_fn(gen, mesh3, 17, 4 * 20, 4, x_axis="space_x",
                        x_extent=40)
    with pytest.raises(ValueError):
        halo_predict(gen, None, torch.zeros((147, 74, 74, 1)), mesh, 17,
                     auto_pad=False)
    assert _padded_extent(160, 4, 17) == 160
    assert _padded_extent(147, 4, 17) == 160


# -- the DP step --------------------------------------------------------------

JAX_CFG2 = JaxConfig(dimsize=74, is3d=False, wf=32)
CFG2 = CycleGANConfig(dimsize=74, is3d=False, wf=32)


def batches(seed, n):
    rng = np.random.default_rng(seed)
    return [(0.3 * rng.normal(size=(n, 74, 74, 1))).astype(np.float32)
            for _ in range(2)]


def redrawn(jstate, seed):
    """Every network redrawn (kernels std 1/sqrt(fan-in), 1-D params
    N(0, 0.1)): O(1) outputs and gradients in all four networks."""
    rng = np.random.default_rng(seed)

    def draw(a):
        std = 0.1 if a.ndim == 1 else float(np.prod(a.shape[:-1])) ** -0.5
        return jnp.asarray(rng.normal(0, std, a.shape).astype(np.float32))

    return jstate.replace(**{t: jax.tree.map(draw, getattr(jstate, t))
                             for t in TREES})


def redrawn_port(seed, cfg=CFG2):
    """A port state with every network redrawn as ``redrawn`` draws it:
    at the N(0, 0.02) init the losses hardly move with the dropout masks,
    so a wrong mask would pass unseen."""
    state = create_state(cfg, 0, device="cpu")
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for t in TREES:
            for p in getattr(state, t).parameters():
                std = (0.1 if p.dim() == 1
                       else float(np.prod(p.shape[:-1])) ** -0.5)
                p.copy_(torch.from_numpy(rng.normal(0, std, tuple(
                    p.shape)).astype(np.float32)))
    return state


def assert_state_close(a, b, rtol=2e-3, atol=1e-5, trees=("gg",)):
    """The parameters of ``trees`` (G's, as JAX's DP tests compare them:
    Keras Adam's first steps move a parameter by about lr whatever the size
    of its gradient, so the discriminators' near-zero biases take any
    float32 difference in their gradients at full scale)."""
    for t in trees:
        for (k, p), q in zip(getattr(a, t).named_parameters(),
                             getattr(b, t).parameters()):
            np.testing.assert_allclose(p.detach().numpy(),
                                       q.detach().numpy(), rtol=rtol,
                                       atol=atol, err_msg=f"{t}.{k}")


def test_dp_step_matches_jax_dp_step():
    """Dropout off, 2D wf=32, global B=8 on 8 devices: the losses against
    JAX's DP step (rtol 1e-4) and the reduced gradients against JAX's
    gradients of the global batch (1e-3 of each network's largest |g|)."""
    jstate = redrawn(jax_create_state(JAX_CFG2, jax.random.PRNGKey(0)), 1)
    x, y = batches(42, 8)
    jmesh = jmake_mesh(8)
    jstep = jax.jit(jax_build_step_fn(JAX_CFG2, deterministic=True),
                    in_shardings=(jreplicated(jmesh), jbatch_sharding(jmesh),
                                  jbatch_sharding(jmesh), jreplicated(jmesh)),
                    out_shardings=(jreplicated(jmesh), jreplicated(jmesh)))
    _, jloss = jstep(jstate, jnp.asarray(x), jnp.asarray(y),
                     jax.random.PRNGKey(0))
    gen, disc_x, disc_y = jax_build_models(JAX_CFG2)
    jgrads, _ = jax.jit(jax.grad(
        lambda gg, gf, dx, dy: jax_losses(
            gen, disc_x, disc_y, BUFFER, 2.0, gg, gf, dx, dy, jnp.asarray(x),
            jnp.asarray(y), jax.random.PRNGKey(0), deterministic=True),
        argnums=(0, 1, 2, 3), has_aux=True))(
            jstate.gg, jstate.gf, jstate.dx, jstate.dy)

    state = create_state(CFG2, 0, device="cpu")
    load_jax_state(state, jax.tree.map(np.asarray, jstate))
    mesh = make_mesh(devices=cpus(8))
    shard_state(state, mesh)
    loss = make_dp_train_step(CFG2, mesh, deterministic=True)(state, x, y, 0)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=1e-4)
    for t, jg in zip(TREES, jgrads):
        want = {k: v.numpy() for k, v in params_from_jax(
            jax.tree.map(np.asarray, jg)).items()}
        got = {k: p.grad.numpy()
               for k, p in getattr(state, t).named_parameters()}
        scale = max(float(np.abs(w).max()) for w in want.values())
        for k in want:
            err = float(np.abs(got[k] - want[k]).max())
            assert err <= 1e-3 * scale, (t, k, err, scale)


# (mesh kwargs, config changes)
DP_CASES = {
    "8_dropout": (dict(), {}),
    "2x4": (dict(data=4, space=2), {}),
    "8_accum2": (dict(), dict(accum_steps=2)),
    "2_accum4": (dict(n_devices=2), dict(accum_steps=4)),
    "4_ensemble_remat": (dict(n_devices=4), dict(ensemble_apps=True,
                                                 remat=True)),
}


@pytest.mark.parametrize("case", list(DP_CASES))
def test_dp_step_matches_single_device(case):
    """Dropout on: every shard draws the global batch's masks and keeps its
    rows, so the DP step equals the single-device step on the global batch
    (JAX splits its key over the logical batch the same way), with
    accum_steps too (each shard runs its rows under their microbatch's
    masks), two steps in a row."""
    mesh_kw, cfg_kw = DP_CASES[case]
    cfg = dataclasses.replace(CFG2, **cfg_kw)
    x, y = batches(2, 8)
    single = redrawn_port(3, cfg)
    meshed = shard_state(redrawn_port(3, cfg),
                         make_mesh(devices=cpus(8), **mesh_kw))
    step1 = make_train_step(cfg, device="cpu")
    mesh = make_mesh(devices=cpus(8), **mesh_kw)
    dp = make_dp_train_step(cfg, mesh)
    for seed in (1, 2):
        l1 = step1(single, x, y, seed)
        l2 = dp(meshed, shard_batch(x, mesh), y, seed)
        np.testing.assert_allclose(l2.numpy(), l1.numpy(), rtol=2e-4,
                                   atol=1e-5)
    assert meshed.step == 2 and meshed.opt_dx.count == 2
    assert_state_close(meshed, single)


def test_row_draw_keeps_the_global_masks_rows():
    """RowDraw gives each shard the rows of the whole batch's mask."""
    y = torch.zeros((6, 5, 5, 2))
    full = _keep_mask(y, torch.Generator().manual_seed(7))
    part = _keep_mask(y[:2], RowDraw(torch.Generator().manual_seed(7), 6,
                                     torch.tensor([3, 1])))
    assert torch.equal(part, full[[3, 1]])


def test_scan_train_step_on_a_mesh_equals_sequential_dp_steps():
    cfg = CFG2
    xs, ys = (np.stack(b) for b in zip(batches(5, 4), batches(6, 4)))
    mesh = make_mesh(devices=cpus(2))
    a = shard_state(create_state(cfg, 0, device="cpu"), mesh)
    b = shard_state(create_state(cfg, 0, device="cpu"), mesh)
    losses = make_scan_train_step(cfg, 2, mesh=mesh)(a, xs, ys, 3)
    dp = make_dp_train_step(cfg, mesh)
    want = torch.stack([dp(b, xs[i], ys[i], 3) for i in range(2)])
    assert torch.equal(losses, want)
    assert_state_close(a, b, rtol=0, atol=0, trees=TREES)


def test_em2em_to_mesh(tmp_path):
    """EM2EM.to_mesh trains data-parallel and matches the single-device
    model given the same seeds and batches; its checkpoint (one copy of
    the state) restores bit-equal into a model on a mesh of another shape
    and into an unmeshed one, and both go on in agreement."""
    x, y = batches(0, 8)
    kw = dict(is3d=False, wf=32, device="cpu")
    single = EM2EM(74, "mesh_single", checkpoint_root=str(tmp_path / "a"),
                   seed=0, **kw)
    meshed = EM2EM(74, "mesh_dp", checkpoint_root=str(tmp_path / "b"),
                   seed=0, **kw)
    assert meshed.to_mesh(make_mesh(devices=cpus(8))) is meshed
    for _ in range(2):
        l1 = single.train_step(x, y)
        l2 = meshed.train_step(x, y)
        np.testing.assert_allclose(l2.numpy(), l1.numpy(), rtol=2e-4,
                                   atol=1e-5)
    assert_state_close(meshed.state, single.state)

    meshed.make_checkpoint(1)
    meshed.wait_until_finished()
    other = EM2EM(74, "mesh_dp", checkpoint_root=str(tmp_path / "b"),
                  seed=99, **kw)  # auto-restores step 1
    plain = EM2EM(74, "mesh_dp", checkpoint_root=str(tmp_path / "b"),
                  seed=98, **kw)
    other.to_mesh(make_mesh(devices=cpus(8), data=4, space=2))
    for m in (other, plain):
        assert m.state.step == 2
        assert_state_close(m.state, meshed.state, rtol=0, atol=0,
                           trees=TREES)
        for t in TREES:
            o, w = getattr(m.state, "opt_" + t), getattr(meshed.state,
                                                         "opt_" + t)
            assert o.count == w.count
            assert all(torch.equal(o.mu[k], w.mu[k]) for k in w.mu)
    l1 = meshed.train_step(x, y)
    for m in (other, plain):
        np.testing.assert_allclose(m.train_step(x, y).numpy(), l1.numpy(),
                                   rtol=2e-4, atol=1e-5)


def test_dp_step_rejects_bad_batches():
    mesh = make_mesh(devices=cpus(4))
    state = shard_state(create_state(CFG2, 0, device="cpu"), mesh)
    dp = make_dp_train_step(CFG2, mesh)
    x, y = batches(0, 6)
    with pytest.raises(ValueError, match="divisible"):
        dp(state, x, y, 0)
    other = make_mesh(devices=cpus(2))
    x, y = batches(0, 4)
    with pytest.raises(ValueError, match="not split over this mesh"):
        dp(state, shard_batch(x, other), shard_batch(y, other), 0)


# -- inference mesh= paths ----------------------------------------------------

@pytest.fixture(scope="module")
def vol():
    return np.random.default_rng(3).integers(0, 255, size=(150, 150, 150),
                                             dtype=np.uint8)


def _assert_close_u8(got, want):
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3, (diff > 0).mean()


REQUEST = ((30, 40, 20), (76, 40, 72))  # 12 tiles


def test_predict_tiled_mesh(model3d, vol):
    """Batches of 6 over data=2 equal the unmeshed call at batch 3, bit for
    bit, and JAX's mesh path within one level; a mesh without 'data', or
    both mesh= and sharding=, raise."""
    jgen, params, gen = model3d

    def fetch(corner, insize):
        return gather_blocks(vol, [corner], insize)[0]

    args = (fetch, gen, *REQUEST, 40, 17, MS_X, MS_Y)
    mesh = make_mesh(devices=cpus(2))
    got = predict_tiled(*args, batch_size=6, mesh=mesh, device="cpu")
    assert np.array_equal(got, predict_tiled(*args, batch_size=3,
                                             device="cpu"))
    want = jpredict_tiled(lambda c, s: jgather(vol, [c], s)[0], jgen.apply,
                          params, *REQUEST, 40, 17, MS_X, MS_Y, batch_size=6,
                          mesh=jmake_mesh(2))
    _assert_close_u8(got, want)
    assert tile_batch(12, 5, 2) == 6 and tile_batch(3, 8, 2) == 4
    space_only = Mesh(np.array(cpus(2), dtype=object), ("space",))
    with pytest.raises(ValueError, match="'data' axis"):
        predict_tiled(*args, mesh=space_only, device="cpu")
    with pytest.raises(ValueError, match="not both"):
        predict_tiled(*args, mesh=mesh, sharding=[CPU, CPU], device="cpu")


def test_predict_ng_cube_mesh(model3d, vol, tmp_path):
    """predict_ng_cube(mesh=) over a file:// ng-precomputed copy of the
    volume equals the unmeshed call at the same batch a device."""
    ts = pytest.importorskip("tensorstore")
    from transfer_em_tpu_torch.infer.tiling import predict_ng_cube

    path = str(tmp_path / "ng")
    spec = {"driver": "neuroglancer_precomputed",
            "kvstore": {"driver": "file", "path": path}, "create": True,
            "schema": {"dtype": "uint8",
                       "domain": {"shape": [150, 150, 150, 1]},
                       "chunk_layout": {"chunk": {"shape": [64, 64, 64, 1]}}}}
    ts.open(spec).result()[...] = vol.transpose(2, 1, 0)[..., None]  # xyz
    _, _, gen = model3d
    kw = dict(outdimsize=40, buffer=17, device="cpu")
    got = predict_ng_cube("file://" + path, *REQUEST, gen, MS_X, MS_Y,
                          batch_size=6, mesh=make_mesh(devices=cpus(2)), **kw)
    want = predict_ng_cube("file://" + path, *REQUEST, gen, MS_X, MS_Y,
                           batch_size=3, **kw)
    assert got.shape == (72, 40, 76) and np.array_equal(got, want)


@pytest.mark.parametrize("start,size,bs", [((40, 40, 40), (72, 72, 36), 1),
                                           ((40, 40, 40), (72, 36, 36), 2)])
def test_device_predict_tiled_mesh(model3d, vol, start, size, bs):
    """Each of 4 devices stitches its batches into its own partial output;
    the max combine equals the unmeshed stitch at the same batch (padding
    batches repeat the last tile) and JAX's mesh path within one level."""
    jgen, params, gen = model3d
    got = device_predict_tiled(vol, gen, start, size, 40, 17, MS_X, MS_Y,
                               batch_size=bs, mesh=make_mesh(
                                   devices=cpus(4)), device="cpu")
    assert np.array_equal(got, device_predict_tiled(
        vol, gen, start, size, 40, 17, MS_X, MS_Y, batch_size=bs,
        device="cpu"))
    want = jdevice_predict_tiled(vol, jgen.apply, params, start, size, 40,
                                 17, MS_X, MS_Y, batch_size=bs,
                                 mesh=jmake_mesh(4))
    _assert_close_u8(got, np.asarray(want))


@pytest.mark.parametrize("mode", ["device", "stream"])
def test_predict_volume_mesh(model3d, vol, mode):
    jgen, params, gen = model3d
    kw = dict(mode=mode, batch_size=2)
    if mode == "stream":
        kw["max_block_bytes"] = 74 ** 3
    got = predict_volume(vol, gen, *REQUEST, MS_X, MS_Y, device="cpu",
                         mesh=make_mesh(devices=cpus(4)), **kw)
    assert np.array_equal(got, predict_volume(vol, gen, *REQUEST, MS_X, MS_Y,
                                              device="cpu", **kw))
    want = jpredict_volume(vol, jgen.apply, params, *REQUEST, MS_X, MS_Y,
                           mesh=jmake_mesh(4), **kw)
    _assert_close_u8(got, np.asarray(want))
    with pytest.raises(ValueError, match="parallel.halo_predict"):
        predict_volume(vol, gen, *REQUEST, MS_X, MS_Y, device="cpu",
                       mode="slab", mesh=make_mesh(devices=cpus(4)))


def test_batcher_mesh(model3d, vol):
    """A batcher over data=2 with max_batch 8 (buckets rounded to the axis)
    serves a 64^3 request (8 tiles, 4 a device) bit-equal to predict_tiled
    at batch 4, and JAX's meshed batcher within one level."""
    jgen, params, gen = model3d

    def fetch(corner, insize):
        return gather_blocks(vol, [corner], insize)[0]

    region = ((64, 64, 64), (64, 64, 64))
    batcher = make_tile_batcher(gen, MS_X, MS_Y, 40, 17, device="cpu",
                                mesh=make_mesh(devices=cpus(2)), max_batch=8,
                                linger_ms=20.0)
    try:
        assert batcher._bucket(3) == 8 and batcher._bucket(9) == 10
        got = predict_tiled(fetch, gen, *region, 40, 17, MS_X, MS_Y,
                            batcher=batcher, device="cpu")
    finally:
        batcher.close()
    assert np.array_equal(got, predict_tiled(fetch, gen, *region, 40, 17,
                                             MS_X, MS_Y, batch_size=4,
                                             device="cpu"))
    jb = jbatcher(jgen.apply, params, MS_X, MS_Y, 40, 17,
                  mesh=jmake_mesh(2), max_batch=8, linger_ms=20.0)
    try:
        want = jpredict_tiled(lambda c, s: jgather(vol, [c], s)[0],
                              jgen.apply, params, *region, 40, 17, MS_X, MS_Y,
                              batcher=jb)
    finally:
        jb.close()
    _assert_close_u8(got, want)


def test_model_service_mesh(model3d, vol, tmp_path):
    """ModelService(mesh=) over data=2 at max_batch 8 writes the bytes of
    the unmeshed service at max_batch 4 (4 tiles a device either way)."""
    _, _, gen = model3d
    d = str(tmp_path / "model")
    export_generator(gen, ExportMeta(17, 40, MS_X, MS_Y, dimsize=74, wf=32),
                     d)
    os.makedirs(tmp_path / "models" / "m1")
    os.symlink(d, tmp_path / "models" / "m1" / "v1")
    register_volume("paralleltest/vol", NumpyVolume(vol))
    outs = {}
    for tag, mesh, mb in (("single", None, 4),
                          ("mesh", make_mesh(devices=cpus(2)), 8)):
        svc = ModelService(model_root=str(tmp_path / "models"), mesh=mesh,
                           max_batch=mb, device="cpu")
        svc.start()
        try:
            dest = tmp_path / f"out_{tag}"
            cfg = {"location": "paralleltest/vol", "start": [64, 64, 64],
                   "glbstart": [0, 0, 0], "size": [64, 64, 64],
                   "model_name": "m1:v1", "dest": str(dest)}
            req = urllib.request.Request(
                svc.url + "/", data=json.dumps(cfg).encode(),
                headers={"Content-type": "application/json"})
            assert urllib.request.urlopen(req, timeout=300).read() == \
                b"success"
            (name,) = os.listdir(dest)
            outs[tag] = gzip.decompress(open(dest / name, "rb").read())
        finally:
            svc.stop()
    assert outs["mesh"] == outs["single"]


def test_initialize_refuses_silent_multi_process_degradation(monkeypatch):
    """initialize() with no arguments: no launcher environment is the
    normal single-process path (warn, go on), unless the environment
    carries multi-process markers (torchrun's WORLD_SIZE > 1 or MASTER_ADDR
    with a WORLD_SIZE, the JAX package's coordinator variables, several
    TPU_WORKER_HOSTNAMES): then it raises."""
    from transfer_em_tpu_torch.parallel import distributed as dist

    for k in ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS",
              "MEGASCALE_COORDINATOR_ADDRESS", "TPU_WORKER_HOSTNAMES",
              "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "RANK"):
        monkeypatch.delenv(k, raising=False)

    def single():
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            dist.initialize()
        assert any("single-process" in str(x.message) for x in w)
        assert not torch.distributed.is_initialized()

    single()
    for env, marker in ((("COORDINATOR_ADDRESS", "10.0.0.1:1234"),),
                        "COORDINATOR_ADDRESS"), \
            ((("TPU_WORKER_HOSTNAMES", "host-a,host-b"),),
             "TPU_WORKER_HOSTNAMES"), \
            ((("WORLD_SIZE", "2"),), "WORLD_SIZE"), \
            ((("WORLD_SIZE", "1"), ("MASTER_ADDR", "10.0.0.1")),
             "MASTER_ADDR"):
        for k, v in env:
            monkeypatch.setenv(k, v)
        with pytest.raises(RuntimeError, match=marker):
            dist.initialize()
        for k, _ in env:
            monkeypatch.delenv(k)
    monkeypatch.setenv("TPU_WORKER_HOSTNAMES", "host-a")
    single()
    assert dist.process_info()[:2] == (0, 1)
    assert dist.gather_objects("x") == ["x"]
    dist.barrier()
    with pytest.raises(ValueError, match="go together"):
        dist.initialize("127.0.0.1:1", num_processes=2)
