"""Axis naming of the mesh backends.

Port of `EmbedMeshSpec` from `repro/embed/distributed.py`.  The row-sharded
sparse backend (sparse/sharding.py) shards over `row_axes`; the 2-D-sharded
dense backend of that module, which `col_axis` also serves, is not ported
yet.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class EmbedMeshSpec:
    """Axis naming for the embedding decomposition."""

    row_axes: tuple[str, ...] = ("data",)
    col_axis: str = "model"

    @property
    def all_axes(self) -> tuple[str, ...]:
        return self.row_axes + (self.col_axis,)
