"""meta.json contract for exported generators.

Own copy of ``ExportMeta`` from ``transfer_em_tpu/config.py`` (reference
utils.py:158-166 writes buffer / outdimsize / meanstd_x / meanstd_y; the
JAX package adds dimsize / is3d / wf so a model can be rebuilt from its
export alone).  The file format is shared: either package reads the other's
meta.json.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple


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
