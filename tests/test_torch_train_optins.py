"""The JAX package's training opt-ins in the port, on the CPU, each held
against the port's own plain step as the JAX package holds its own
(tests/test_train.py, tests/test_e2e.py): ``remat`` bit-equal to remat off
with dropout on, ``ensemble_apps`` equal to ``batched_apps`` within JAX's
tolerances (with and without a disc_prior), the kernels' Functions under
``torch.func.vmap``, and the scan window (``make_scan_train_step``,
``EM2EM.train(scan_window=k)``) equal to sequential steps.  2D wf=32, 74^2,
B=2 (the JAX tests' setup) unless a test says otherwise; weights redrawn to
O(1), batches N(0, 0.3^2) from numpy seeds."""

import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.func import functional_call, vmap

from transfer_em_tpu_torch.config import CycleGANConfig
from transfer_em_tpu_torch.models import UNetGenerator
from transfer_em_tpu_torch.models.blocks import dropout_half
from transfer_em_tpu_torch.models.convert import TREES
from transfer_em_tpu_torch.ops import cuda_conv
from transfer_em_tpu_torch.ops.cuda_kernels import leaky_relu
from transfer_em_tpu_torch.shapes import generator_shapes
from transfer_em_tpu_torch.train import (EM2EM, build_step_fn, create_state,
                                         cyclegan_losses,
                                         make_scan_train_step)
from transfer_em_tpu_torch.train.cgan import _dropout_generators, _tap_prior
from test_torch_train_step import redraw_port

torch.set_num_threads(1)

BUFFER = generator_shapes(74).buffer
CFG = CycleGANConfig(dimsize=74, is3d=False, wf=32, batch_size=2)


def _batches(seed, n, is3d=False):
    rng = np.random.default_rng(seed)
    shape = (n,) + (74,) * (3 if is3d else 2) + (1,)
    return [torch.from_numpy((0.3 * rng.normal(size=shape)).astype(
        np.float32)) for _ in range(2)]


def _grads(cfg, x, y, prior=None, seed=11, **kw):
    """Losses and gradients of one combined loss, dropout on (the
    generators of (seed, step 0)), from a redrawn state."""
    state = redraw_port(create_state(cfg, 0, "cpu", disc_prior=prior), 2)
    nets = [getattr(state, t) for t in TREES]
    combined, vec = cyclegan_losses(*nets, BUFFER, 2.0, x, y,
                                    _dropout_generators(x.device, seed, 0),
                                    **kw)
    combined.backward()
    return vec, [{k: p.grad.clone() for k, p in n.named_parameters()}
                 for n in nets]


@pytest.mark.parametrize("case", ["2d-f32", "2d-bf16", "3d-f32", "3d-bf16",
                                  "2d-f32-ensemble"])
def test_remat_bit_equal(case):
    """remat (each generator application under torch.utils.checkpoint, its
    dropout generator rewound for the recompute) gives the same losses and
    gradients bit for bit as remat off, with dropout on; also with
    ensemble_apps (the vmapped rounds checkpointed)."""
    dim, dtype, *rest = case.split("-")
    is3d = dim == "3d"
    cfg = dataclasses.replace(CFG, is3d=is3d, compute_dtype={
        "f32": "float32", "bf16": "bfloat16"}[dtype])
    x, y = _batches(3, 1 if is3d else 2, is3d)
    kw = {"ensemble_apps": bool(rest)}
    off = _grads(cfg, x, y, **kw)
    on = _grads(cfg, x, y, remat=True, **kw)
    assert torch.equal(off[0], on[0])
    for a, b in zip(off[1], on[1]):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    # dropout ran: other seeds give other losses
    assert not torch.equal(off[0], _grads(cfg, x, y, seed=12, **kw)[0])


def test_remat_recompute_rewinds_the_dropout_generator():
    """The trap remat avoids: a checkpoint around a generator application
    whose dropout draws from an explicit torch.Generator (checkpoint's own
    RNG bookkeeping covers the default generators only) recomputes with
    other masks and gives other gradients; the step's remat rewinds the
    generator and gives remat off's."""
    from torch.utils.checkpoint import checkpoint

    gen = redraw_port_gen(UNetGenerator(wf=32, is3d=False))
    x = _batches(4, 2)[0]

    def grads(remat):
        gen.zero_grad(set_to_none=True)
        g = torch.Generator().manual_seed(1)
        fn = lambda a: gen(a, deterministic=False, dropout_generator=g)
        out = checkpoint(fn, x, use_reentrant=False) if remat else fn(x)
        out.square().sum().backward()
        return [p.grad.clone() for p in gen.parameters()]

    assert any(not torch.equal(a, b) for a, b in zip(grads(False),
                                                     grads(True)))


def _assert_close(got, want):
    """JAX's test_ensemble_apps_equivalent tolerances: losses rtol 1e-5,
    atol 1e-6; gradients rtol 5e-4, atol 1e-6."""
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=1e-5,
                               atol=1e-6)
    for a, b in zip(got[1], want[1]):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(a[k].numpy(), b[k].numpy(),
                                       rtol=5e-4, atol=1e-6, err_msg=k)


def test_ensemble_apps_equals_batched_apps():
    """ensemble_apps (G/F and Dx/Dy stacked, one torch.func.vmap a round)
    == batched_apps for the loss vector and every gradient, with dropout
    on: each stacked generator draws its masks from its own application's
    generator, as batched_apps does."""
    x, y = _batches(5, 2)
    _assert_close(_grads(CFG, x, y, ensemble_apps=True), _grads(CFG, x, y))


def test_ensemble_apps_with_prior_stacks_the_generators_only():
    """With a disc_prior disc_y's down3 is wider, so only G and F stack;
    the result still equals batched_apps."""
    x, y = _batches(6, 2)
    prior = _tap_prior(redraw_port_gen(UNetGenerator(wf=32, is3d=False)),
                       "down1")
    got = _grads(CFG, x, y, prior=prior, ensemble_apps=True)
    _assert_close(got, _grads(CFG, x, y, prior=prior))


def redraw_port_gen(gen, seed=9):
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in gen.parameters():
            p.copy_(torch.from_numpy(rng.normal(0, float(np.prod(
                p.shape[:-1])) ** -0.5, tuple(p.shape)).astype(np.float32)))
    return gen


def test_ensemble_step_equals_batched_step():
    """build_step_fn with config.ensemble_apps: one update equals the
    batched step's (dropout on)."""
    x, y = _batches(7, 2)
    states = [redraw_port(create_state(CFG, 0, "cpu"), 2) for _ in range(2)]
    la = build_step_fn(CFG)(states[0], x, y, 3)
    lb = build_step_fn(dataclasses.replace(CFG, ensemble_apps=True))(
        states[1], x, y, 3)
    np.testing.assert_allclose(lb.numpy(), la.numpy(), rtol=1e-5, atol=1e-6)
    for t in TREES:
        for p, q in zip(getattr(states[0], t).parameters(),
                        getattr(states[1], t).parameters()):
            np.testing.assert_allclose(q.detach().numpy(),
                                       p.detach().numpy(), rtol=1e-4,
                                       atol=1e-5)


@pytest.mark.parametrize("leaky", [None, 0.3])
def test_conv3_under_vmap(leaky):
    """conv3's Function under vmap over stacked weights and inputs: one
    call per stacked network (its vmap rule), the same values and
    gradients as the networks applied one by one."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(2, 3, 7, 8, 9, 4)).astype(
        np.float32)).requires_grad_(True)
    w = torch.from_numpy((rng.normal(size=(2, 3, 3, 3, 4, 8)) / 10).astype(
        np.float32)).requires_grad_(True)
    y = vmap(lambda a, b: cuda_conv.conv3(a, b, leaky))(x, w)
    want = torch.stack([cuda_conv.conv3(x[i], w[i], leaky)
                        for i in range(2)])
    assert torch.equal(y, want)
    g = torch.from_numpy(rng.normal(size=tuple(y.shape)).astype(np.float32))
    gx, gw = torch.autograd.grad(y, (x, w), g)
    wx, ww = torch.autograd.grad(want, (x, w), g)
    assert torch.equal(gx, wx) and torch.equal(gw, ww)
    # one weight shared by both inputs (in_dims None for w)
    y1 = vmap(lambda a: cuda_conv.conv3(a, w[0], leaky))(x)
    assert torch.equal(y1[1], cuda_conv.conv3(x[1], w[0], leaky))


def test_leaky_relu_and_dropout_under_vmap():
    """LeakyReLU's Function under vmap (one call for the stack), and
    dropout's keep mask drawn per stacked network from its own generator,
    equal to each network's own draw."""
    rng = np.random.default_rng(9)
    v = torch.from_numpy(rng.normal(size=(2, 5, 6, 7)).astype(
        np.float32)).requires_grad_(True)
    y = vmap(leaky_relu)(v)
    assert torch.equal(y, leaky_relu(v))
    (g,) = torch.autograd.grad(y.sum(), v)
    assert torch.equal(g, torch.where(v >= 0, 1.0, 0.3))
    gens = [torch.Generator().manual_seed(s) for s in (1, 2)]
    out = vmap(lambda a: dropout_half(a, gens))(v)
    again = [torch.Generator().manual_seed(s) for s in (1, 2)]
    assert torch.equal(out, torch.stack([dropout_half(v[i], again[i])
                                         for i in range(2)]))
    with pytest.raises(ValueError, match="3 dropout generators"):
        vmap(lambda a: dropout_half(a, gens + gens[:1]))(v)


def test_generator_under_vmap_with_stacked_params():
    """A generator vmapped over two stacked parameter sets (the
    ensemble's round) equals the two networks applied one by one."""
    nets = [redraw_port_gen(UNetGenerator(wf=32, is3d=False), s)
            for s in (1, 2)]
    stacked = {k: torch.stack([p, q]) for (k, p), q in
               zip(nets[0].named_parameters(), nets[1].parameters())}
    x = _batches(10, 2)[0]
    xs = torch.stack([x, x.flip(0)])
    got = vmap(lambda p, a: functional_call(nets[0], p, (a,)))(stacked, xs)
    for i in range(2):
        np.testing.assert_allclose(got[i].detach().numpy(),
                                   nets[i](xs[i]).detach().numpy(),
                                   rtol=1e-5, atol=1e-6)


def _params(state):
    return [p.detach().clone() for t in TREES
            for p in getattr(state, t).parameters()]


def test_scan_window_equals_sequential():
    """make_scan_train_step(window=3): losses (3, 7) and the updated
    state equal three sequential make_train_step calls with the same seed,
    dropout on (JAX's tolerances: losses rtol 2e-5, atol 2e-6; parameters
    rtol 1e-4, atol 1e-5)."""
    from transfer_em_tpu_torch.train import make_train_step

    K = 3
    xs, ys = _batches(7, 2 * K)
    xs, ys = xs.reshape(K, 2, 74, 74, 1), ys.reshape(K, 2, 74, 74, 1)
    seq, scanned = (redraw_port(create_state(CFG, 0, "cpu"), 1)
                    for _ in range(2))
    step = make_train_step(CFG, device="cpu")
    want = torch.stack([step(seq, xs[i], ys[i], 11) for i in range(K)])
    scan = make_scan_train_step(CFG, K, device="cpu")
    got = scan(scanned, xs, ys, 11)
    assert got.shape == (K, 7) and scanned.step == seq.step == K
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-6)
    for a, b in zip(_params(scanned), _params(seq)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_2d_step_at_batch_one():
    """A 2D step on one tile (the ragged batch above) runs on the CPU,
    where PyTorch picks slow_conv2d, which refuses a strided weight
    gradient (it raised RuntimeError before the conv's weight was made
    contiguous there), and its losses are cyclegan_losses' on that tile
    (dropout off)."""
    x, y = _batches(12, 2)
    one, two = (redraw_port(create_state(CFG, 0, "cpu"), 1)
                for _ in range(2))
    l1 = build_step_fn(CFG, deterministic=True)(one, x[:1], y[:1], 0)
    nets = [getattr(two, t) for t in TREES]
    _, want = cyclegan_losses(*nets, BUFFER, 2.0, x[:1], y[:1],
                              deterministic=True)
    assert one.step == 1 and torch.isfinite(l1).all()
    np.testing.assert_allclose(l1.numpy(), want.numpy(), rtol=1e-6)


def test_scan_window_rejects_bad_arguments():
    with pytest.raises(ValueError, match="window"):
        make_scan_train_step(CFG, 0, device="cpu")
    from transfer_em_tpu_torch.parallel import make_mesh
    with pytest.raises(ValueError, match="window"):
        make_scan_train_step(CFG, 0, mesh=make_mesh(
            devices=[torch.device("cpu")] * 2))
    scan = make_scan_train_step(CFG, 2, device="cpu")
    state = create_state(CFG, 0, "cpu")
    x = torch.zeros((3, 2, 74, 74, 1))
    with pytest.raises(ValueError, match="window=2"):
        scan(state, x, x, 0)


def _model(root, name, **kw):
    return EM2EM(74, name, is3d=False, wf=32, checkpoint_root=str(root),
                 device="cpu", seed=9, **kw)


def _losses(log):
    with open(log) as f:
        return [json.loads(line)["loss"] for line in f]


@pytest.mark.parametrize("sizes", [(2, 2, 2), (2, 1, 2, 2)],
                         ids=["tail", "ragged"])
def test_em2em_train_scan_window_equals_plain(tmp_path, sizes):
    """EM2EM.train(scan_window=2) logs the same epoch losses and lands on
    the same state as scan_window=1, with an epoch of three batches (a
    window and a tail) and one whose second batch has another size (which
    the JAX package flushes through single steps)."""
    rng = np.random.default_rng(5)
    xs = [(0.3 * rng.normal(size=(b, 74, 74, 1))).astype(np.float32)
          for b in sizes]
    ys = [(0.3 * rng.normal(size=(b, 74, 74, 1))).astype(np.float32)
          for b in sizes]
    runs = {}
    for window in (1, 2):
        m = _model(tmp_path / str(window), "scan")
        log = str(tmp_path / f"{window}.jsonl")
        m.train(xs, ys, epochs=2, check_freq=10, metrics_log=log,
                scan_window=window)
        runs[window] = (m, _losses(log))
    (plain, lp), (scanned, ls) = runs[1], runs[2]
    assert plain.state.step == scanned.state.step == 2 * len(sizes)
    for a, b in zip(lp, ls):
        np.testing.assert_allclose(list(b.values()), list(a.values()),
                                   rtol=2e-5, atol=2e-6)
    for a, b in zip(_params(scanned.state), _params(plain.state)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)
