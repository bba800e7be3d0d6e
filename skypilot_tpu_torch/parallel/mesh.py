"""Logical mesh shape: the port's copy of ``MeshSpec``.

Port of ``skypilot_tpu/parallel/mesh.py``'s ``MeshSpec`` and its
``resolve``, and nothing else of that module: the port trains on one
device, so ``train.run --mesh`` only checks that a spec resolves to one
device (``fsdp=-1`` does) and refuses any larger one. Building a device
mesh over ``torch.distributed`` comes with sharded training.

The axes follow the MaxText/scaling-book convention: ``data``, ``pipe``,
``fsdp``, ``seq``, ``expert``, ``tensor``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

AXIS_ORDER = ('data', 'pipe', 'fsdp', 'seq', 'expert', 'tensor')


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape. Unspecified axes default to 1; a single -1 axis
    absorbs the remaining devices (like a reshape)."""
    data: int = 1
    pipe: int = 1
    fsdp: int = -1
    seq: int = 1
    expert: int = 1
    tensor: int = 1

    def resolve(self, n_devices: int) -> Dict[str, int]:
        sizes = {a: getattr(self, a) for a in AXIS_ORDER}
        minus = [a for a, s in sizes.items() if s == -1]
        if len(minus) > 1:
            raise ValueError(f'At most one -1 axis allowed, got {minus}')
        known = math.prod(s for s in sizes.values() if s != -1)
        if minus:
            if n_devices % known:
                raise ValueError(
                    f'{n_devices} devices not divisible by fixed axes {sizes}')
            sizes[minus[0]] = n_devices // known
        if math.prod(sizes.values()) != n_devices:
            raise ValueError(
                f'Mesh {sizes} does not use all {n_devices} devices.')
        return sizes

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return AXIS_ORDER
