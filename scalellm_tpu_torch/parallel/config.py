"""Parallelism configuration (a copy of scalellm_tpu/parallel/config.py,
which imports only dataclasses).

The field names are the reference's. In this package the axis names only
say whether an axis is in use: the collectives run over the process groups
of parallel/mesh.py, one process a rank.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ParallelConfig:
    # Mesh axis name for tensor parallelism (None = single device).
    tp_axis: Optional[str] = None
    # Mesh axis name for data parallelism (replica groups), optional.
    dp_axis: Optional[str] = None
    # Mesh axis name for expert parallelism (MoE), optional.
    ep_axis: Optional[str] = None
    # Sizes (1 when axis unused) — static, needed for weight partitioning.
    tp_size: int = 1
    dp_size: int = 1
    ep_size: int = 1
    # Megatron-style sequence parallelism over the tp axis: norms/residuals/
    # embedding are sharded over the TOKEN dim; activations are all_gathered
    # before column-parallel projections and reduce_scattered after
    # row-parallel ones. Same bytes on the wire as plain TP's all_reduce
    # (AG + RS = AR) but the elementwise/norm traffic drops by tp_size.
    # Dense models only (MoE/LoRA paths keep plain TP).
    sp: bool = False

    @property
    def is_parallel(self) -> bool:
        return self.tp_size > 1 or self.dp_size > 1 or self.ep_size > 1
