"""Training config and the meta.json contract for exported generators.

Own copies of ``CycleGANConfig`` and ``ExportMeta`` from
``transfer_em_tpu/config.py``.  ExportMeta: reference utils.py:158-166
writes buffer / outdimsize / meanstd_x / meanstd_y; the JAX package adds
dimsize / is3d / wf so a model can be rebuilt from its export alone.  Both
JSON formats are shared: either package reads the other's files.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple


@dataclasses.dataclass
class CycleGANConfig:
    """Model and training hyperparameters (reference EM2EM.__init__,
    cgan.py:40), the JAX package's fields but two.  The train step
    (train/cgan.py) takes every one of them: 3D or 2D, float32 or
    bfloat16, ``remat``, ``ensemble_apps`` and ``accum_steps``.
    ``batch_size``, ``epoch_size`` and ``buffer_size`` are the dataset's
    (reference datasets.py:10-12), for a caller that builds the pipelines.
    The JAX package's ``fast_conv`` and ``dropout_impl`` select nothing
    here, and ``from_json`` drops them: the port always runs its kernels and
    draws its dropout masks from a torch.Generator."""

    dimsize: int = 74
    is3d: bool = True
    wf: int = 8
    focal_gamma: float = 2.0
    use_norm: bool = False          # norm_type is disabled upstream
    learning_rate: float = 2e-4
    adam_beta1: float = 0.5
    compute_dtype: str = "float32"
    remat: bool = False
    ensemble_apps: bool = False
    accum_steps: int = 1            # microbatches per optimizer update
    batch_size: int = 64            # reference datasets.py:10-12
    epoch_size: int = 4096
    buffer_size: int = 4096

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "CycleGANConfig":
        d = json.loads(s)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclasses.dataclass
class ExportMeta:
    """meta.json contract for exported generators."""

    buffer: int
    outdimsize: int
    meanstd_x: Tuple[float, float]
    meanstd_y: Tuple[float, float]
    dimsize: int = 74
    is3d: bool = True
    wf: int = 8

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["meanstd_x"] = list(self.meanstd_x)
        d["meanstd_y"] = list(self.meanstd_y)
        return json.dumps(d)

    @classmethod
    def from_json(cls, s: str) -> "ExportMeta":
        d = json.loads(s)
        known = {f.name for f in dataclasses.fields(cls)}
        d = {k: v for k, v in d.items() if k in known}
        d["meanstd_x"] = tuple(d["meanstd_x"])
        d["meanstd_y"] = tuple(d["meanstd_y"])
        return cls(**d)
