"""LUT preparation: Lut3D -> the device-ready table plus its domain mapping.

The LUT core (ops.lut3d) reads the (N, N, N, 3) float32 table with XLA
gathers, so preparation only fixes the dtype and carries the DOMAIN_MIN/MAX
of the .cube file, which the apply path maps inputs through exactly like the
reference oracle (colorcore.interp._prepare).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..colorcore.cube import Lut3D


@dataclass
class PreparedLut:
    table: np.ndarray       # (N, N, N, 3) float32
    size: int               # N
    domain_min: np.ndarray  # (3,) float32
    domain_max: np.ndarray  # (3,) float32

    @property
    def has_unit_domain(self) -> bool:
        return bool(
            np.allclose(self.domain_min, 0.0) and np.allclose(self.domain_max, 1.0)
        )


def prepare_lut(lut: Lut3D) -> PreparedLut:
    table = np.ascontiguousarray(lut.table, dtype=np.float32)
    return PreparedLut(
        table=table,
        size=table.shape[0],
        domain_min=np.asarray(lut.domain_min, np.float32),
        domain_max=np.asarray(lut.domain_max, np.float32),
    )
