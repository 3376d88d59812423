"""Two faults of the port's parallel layer, held on the CPU.

* A data-parallel replica of disc_y runs a frozen prior of its own on its
  own device (``parallel.mesh.replicas`` rebuilds the prior's generator
  there; the prior is no submodule, so a module copy alone would share
  the home device's tensors).  Every CPU tensor reports ``cpu``, so these
  tests check which tensors each replica's prior uses, on a ``[cpu,
  cpu:0]`` mesh (``cpu:0`` is a device of its own to ``replicas``).
* A replica is refreshed when a parameter is swapped for another tensor at
  an equal version count (``load_state_dict(sd, assign=True)``), not only
  when a version counter moves.

The DP step with a prior is held against the single-device step with the
tolerances of tests/test_torch_parallel.py (losses rtol 2e-4, G's
parameters rtol 2e-3).
"""

import numpy as np
import pytest
import torch

from transfer_em_tpu_torch.config import CycleGANConfig
from transfer_em_tpu_torch.infer import predict_tiled
from transfer_em_tpu_torch.models import UNetGenerator
from transfer_em_tpu_torch.native import gather_blocks
from transfer_em_tpu_torch.parallel import (make_dp_train_step, make_mesh,
                                            shard_batch, shard_state)
from transfer_em_tpu_torch.parallel.mesh import replicas
from transfer_em_tpu_torch.train import EM2EM, create_state, make_train_step
from transfer_em_tpu_torch.train.cgan import _tap_prior

torch.set_num_threads(1)

CPU, CPU0 = torch.device("cpu"), torch.device("cpu", 0)
CFG2 = CycleGANConfig(dimsize=74, is3d=False, wf=32)
MS_X, MS_Y = (0.1, 0.9), (0.05, 1.1)


def _prior(seed):
    gen = UNetGenerator(wf=32, is3d=False,
                        generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():  # O(1) features, so a wrong prior shows
        for p in gen.parameters():
            p.mul_(float(np.prod(p.shape[:-1])) ** -0.5 / 0.02)
    return _tap_prior(gen, "down1")


def _batches(seed, n):
    rng = np.random.default_rng(seed)
    return [(0.3 * rng.normal(size=(n, 74, 74, 1))).astype(np.float32)
            for _ in range(2)]


def _ptrs(prior):
    return {t.data_ptr() for t in prior.params.values()}


def test_disc_y_replica_runs_its_own_prior():
    """The replica's prior holds tensors of its own, equal in value to the
    home prior's, and its forward reads them: zeroing them changes the
    replica's features and leaves the home prior's alone.  A prior swapped
    on the home module is rebuilt on the replica at the next call."""
    state = create_state(CFG2, 0, device="cpu", disc_prior=_prior(5))
    home, rep = replicas(state.dy, [CPU, CPU0])
    assert home is state.dy and rep is not home
    assert rep.disc_prior is not home.disc_prior
    assert not _ptrs(rep.disc_prior) & _ptrs(home.disc_prior)
    for k, t in home.disc_prior.params.items():
        assert torch.equal(rep.disc_prior.params[k], t)
    x = torch.from_numpy(_batches(1, 2)[0])
    with torch.no_grad():
        want = home.disc_prior(x)
        assert torch.equal(rep.disc_prior(x), want)
        for t in rep.disc_prior.params.values():
            t.zero_()
        assert not torch.equal(rep.disc_prior(x), want)
        assert torch.equal(home.disc_prior(x), want)
    other = _prior(6)
    state.dy.disc_prior = other
    assert replicas(state.dy, [CPU0])[0] is rep
    for k, t in other.params.items():
        assert torch.equal(rep.disc_prior.params[k], t)
    assert not _ptrs(rep.disc_prior) & _ptrs(other)


@pytest.mark.parametrize("accum", [1, 2])
def test_dp_step_with_a_prior_matches_single_device(accum):
    """disc_y with a prior on a two-device mesh: two DP steps (dropout on)
    equal two single-device steps on the global batch."""
    import dataclasses
    cfg = dataclasses.replace(CFG2, accum_steps=accum)
    x, y = _batches(2, 4)
    single = create_state(cfg, 0, device="cpu", disc_prior=_prior(7))
    mesh = make_mesh(devices=[CPU, CPU0])
    meshed = shard_state(create_state(cfg, 0, device="cpu",
                                      disc_prior=_prior(7)), mesh)
    step1 = make_train_step(cfg, device="cpu")
    dp = make_dp_train_step(cfg, mesh)
    for seed in (1, 2):
        l1 = step1(single, x, y, seed)
        l2 = dp(meshed, shard_batch(x, mesh), y, seed)
        np.testing.assert_allclose(l2.numpy(), l1.numpy(), rtol=2e-4,
                                   atol=1e-5)
    for (k, p), q in zip(meshed.gg.named_parameters(),
                         single.gg.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   rtol=2e-3, atol=1e-5, err_msg=k)


def test_em2em_to_mesh_with_a_prior(tmp_path):
    """EM2EM(..., disc_prior=p).to_mesh() trains: its first step equals the
    unmeshed model's."""
    x, y = _batches(3, 4)
    kw = dict(is3d=False, wf=32, device="cpu", seed=0)
    single = EM2EM(74, "prior_single", checkpoint_root=str(tmp_path / "a"),
                   disc_prior=_prior(8), **kw)
    meshed = EM2EM(74, "prior_dp", checkpoint_root=str(tmp_path / "b"),
                   disc_prior=_prior(8), **kw).to_mesh(
                       make_mesh(devices=[CPU, CPU0]))
    np.testing.assert_allclose(meshed.train_step(x, y).numpy(),
                               single.train_step(x, y).numpy(), rtol=2e-4,
                               atol=1e-5)


def _same_versions(params, tensors):
    """Bump each new tensor's version counter (by adding 0 in place, which
    changes no value) up to its parameter's, so only the identity
    differs."""
    with torch.no_grad():
        for p, t in zip(params, tensors):
            assert t._version <= p._version
            while t._version < p._version:
                t.add_(0)


def test_replica_refreshed_after_assign_at_an_equal_version():
    """load_state_dict(sd, assign=True) with every new tensor at its old
    parameter's version count: the replica takes the new weights."""
    net = torch.nn.Linear(3, 2)
    home, rep = replicas(net, [CPU, CPU0])
    sd = {k: torch.randn(v.shape) for k, v in net.state_dict().items()}
    _same_versions(net.parameters(), sd.values())
    before = [p._version for p in net.parameters()]
    net.load_state_dict(sd, assign=True)
    assert [p._version for p in net.parameters()] == before
    assert replicas(net, [CPU0])[0] is rep
    assert torch.equal(rep.weight, sd["weight"])
    assert torch.equal(rep.bias, sd["bias"])


def test_meshed_predict_after_assign_equals_unmeshed():
    """predict_tiled over a [cpu, cpu:0] mesh after the generator's weights
    were swapped by load_state_dict(assign=True) at equal version counts:
    bit-equal to the unmeshed call at the same batch a device."""
    vol = np.random.default_rng(3).integers(0, 255, size=(120, 120, 120),
                                            dtype=np.uint8)

    def fetch(corner, insize):
        return gather_blocks(vol, [corner], insize)[0]

    gen = UNetGenerator(wf=32, generator=torch.Generator().manual_seed(1))
    gen.eval()
    request = ((30, 40, 20), (40, 40, 80))  # 2 tiles
    mesh = make_mesh(devices=[CPU, CPU0])
    args = (fetch, gen, *request, 40, 17, MS_X, MS_Y)
    first = predict_tiled(*args, batch_size=2, mesh=mesh, device="cpu")
    new = UNetGenerator(wf=32, generator=torch.Generator().manual_seed(2))
    sd = {k: v.detach().clone() for k, v in new.state_dict().items()}
    with torch.no_grad():  # O(1) outputs, so stale weights show
        for k, v in sd.items():
            v.mul_(float(np.prod(v.shape[:-1])) ** -0.5 / 0.02)
    _same_versions(gen.parameters(), sd.values())
    before = [p._version for p in gen.parameters()]
    gen.load_state_dict(sd, assign=True)
    assert [p._version for p in gen.parameters()] == before
    got = predict_tiled(*args, batch_size=2, mesh=mesh, device="cpu")
    want = predict_tiled(*args, batch_size=1, device="cpu")
    assert not np.array_equal(want, first)
    assert np.array_equal(got, want)
