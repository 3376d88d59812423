"""Train-state checkpoints with crash-safe commits (the port's stand-in for
the orbax manager of transfer_em_tpu/train/cgan.py:521-586, reference
``tf.train.CheckpointManager``, cgan.py:84-103).

Layout: ``<directory>/<step>/state.pt``, one directory per step (the
orchestrator's epoch), written by ``torch.save`` and read by
``torch.load(weights_only=True)``.  The JAX package cannot read these
files, and the port cannot read orbax's.

What a checkpoint holds (``snapshot``): ``step``; the four networks'
parameters by ``named_parameters`` name (their whole ``state_dict``: the
networks hold no buffers); each Adam state's ``count``, ``mu`` and ``nu``;
all tensors on the host.

* **Crash-safe commit.**  A save writes into a hidden temporary directory,
  fsyncs the file, renames the directory to its step number and fsyncs the
  parent.  ``latest_step`` and ``all_steps`` see only committed step
  directories, so a partial left by a crash is ignored.
* **Background writer.**  ``save`` hands the snapshot to one writer thread,
  as orbax saves asynchronously; the snapshot must already be a host copy
  (``snapshot``), taken synchronously, because the train step updates the
  device tensors in place.  ``wait_until_finished`` drains the writer and
  raises its error, if any.
* **Retention.**  At most ``max_to_keep`` committed steps; the oldest go.
"""

from __future__ import annotations

import os
import shutil
import threading
import uuid
from typing import Dict, List, Optional

import torch

from ..models.convert import TREES

STATE_FILE = "state.pt"
_TMP_PREFIX = ".tmp-"


def snapshot(state) -> Dict:
    """A host copy of a ``CycleGANState``, taken now (the device-to-host
    copies are synchronous): safe to write while training goes on."""
    def host(t: torch.Tensor) -> torch.Tensor:
        return t.detach().to("cpu", copy=True)

    out: Dict = {"step": int(state.step), "nets": {}, "opt": {}}
    for t in TREES:
        out["nets"][t] = {k: host(v)
                          for k, v in getattr(state, t).named_parameters()}
        opt = getattr(state, "opt_" + t)
        out["opt"][t] = {"count": int(opt.count),
                         "mu": {k: host(v) for k, v in opt.mu.items()},
                         "nu": {k: host(v) for k, v in opt.nu.items()}}
    return out


def _copy_into(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor],
               what: str) -> None:
    if set(dst) != set(src):
        raise ValueError(f"checkpoint {what}: keys differ: "
                         f"{sorted(set(dst) ^ set(src))}")
    for k, t in dst.items():
        if tuple(t.shape) != tuple(src[k].shape):
            raise ValueError(f"checkpoint {what}.{k}: shape "
                             f"{tuple(src[k].shape)} != {tuple(t.shape)}")
    with torch.no_grad():
        for k, t in dst.items():
            t.copy_(src[k])


def load_into(state, snap: Dict) -> None:
    """Write a snapshot into ``state`` in place: every parameter and Adam
    moment through ``copy_`` under ``no_grad`` (never ``.data``), so each
    version counter moves and conv3's packed-weight cache repacks; then the
    Adam counts and ``step`` (which, with the seed, fixes the dropout masks
    of the steps that follow)."""
    for t in TREES:
        net = getattr(state, t)
        _copy_into(dict(net.named_parameters()), snap["nets"][t], t)
        opt, src = getattr(state, "opt_" + t), snap["opt"][t]
        _copy_into(opt.mu, src["mu"], f"opt_{t}.mu")
        _copy_into(opt.nu, src["nu"], f"opt_{t}.nu")
        opt.count = int(src["count"])
    state.step = int(snap["step"])


def read_checkpoint(path: str) -> Dict:
    """The snapshot committed in the step directory ``path``."""
    return torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                      weights_only=True)


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class CheckpointManager:
    """Numbered checkpoints under ``directory`` (created at the first
    save)."""

    def __init__(self, directory: str, max_to_keep: int = 50):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def all_steps(self) -> List[int]:
        """Committed steps, ascending."""
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.isfile(
                          os.path.join(self.directory, n, STATE_FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def step_path(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def save(self, step: int, snap: Dict) -> None:
        """Commit ``snap`` (a host copy, see :func:`snapshot`) as ``step``
        on the writer thread, after any save still in flight."""
        self.wait_until_finished()
        self._thread = threading.Thread(target=self._write,
                                        args=(int(step), snap), daemon=True)
        self._thread.start()

    def wait_until_finished(self) -> None:
        """Block until the save in flight, if any, is committed; raise the
        error it hit."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write(self, step: int, snap: Dict) -> None:
        try:
            self._commit(step, snap)
            self._prune()
        except BaseException as e:  # raised by wait_until_finished
            self._error = e

    def _commit(self, step: int, snap: Dict) -> None:
        os.makedirs(self.directory, exist_ok=True)
        tmp = os.path.join(self.directory,
                           f"{_TMP_PREFIX}{step}-{uuid.uuid4().hex}")
        os.makedirs(tmp)
        with open(os.path.join(tmp, STATE_FILE), "wb") as f:
            torch.save(snap, f)
            f.flush()
            os.fsync(f.fileno())
        final = self.step_path(step)
        if os.path.exists(final):  # the same step saved again: replace it
            old = os.path.join(self.directory,
                               f"{_TMP_PREFIX}old-{step}-{uuid.uuid4().hex}")
            os.replace(final, old)
            os.replace(tmp, final)
            shutil.rmtree(old)
        else:
            os.replace(tmp, final)
        _fsync_dir(self.directory)

    def _prune(self) -> None:
        for step in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self.step_path(step))
