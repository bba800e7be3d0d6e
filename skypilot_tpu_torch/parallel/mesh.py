"""Device mesh over ``torch.distributed``.

Port of ``skypilot_tpu/parallel/mesh.py``. The axes follow the
MaxText/scaling-book convention: ``data``, ``pipe``, ``fsdp``, ``seq``,
``expert``, ``tensor`` (innermost, so it rides the fastest links).

JAX builds one mesh of devices inside one controller process. PyTorch's
idiom, and NCCL's, is one process per rank, so a ``Mesh`` here is this
rank's view of the gang: the axis sizes (JAX's ``mesh.shape``), this
rank's coordinate on each axis, and a process group per axis, from
``torch.distributed.device_mesh.init_device_mesh`` with ``AXIS_ORDER`` as
its dim names. Ranks are laid out row-major over ``AXIS_ORDER``, so with
``num_slices > 1`` each slice is a contiguous block of ranks and the
``data`` axis, outermost, is the only one that crosses slices (DCN), as
JAX's hybrid mesh places it.

With no process group initialised the world is one process, and
``build_mesh`` gives the one-device mesh, so single-device callers do not
change. The collective backend is chosen by the topology, never as a
fallback on error (``backend_for``): NCCL where each local rank has a GPU
of its own, gloo where ranks share a device or run on the CPU; gloo stages
CUDA tensors through host memory (``parallel/collectives.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

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


class Mesh:
    """This rank's view of a device mesh: ``shape`` (axis -> size, JAX's
    ``mesh.shape``), ``axis_names``, ``device`` (where this rank
    computes), ``backend`` (None for one process), and per axis its
    process group and this rank's index on it."""

    def __init__(self, sizes: Dict[str, int], device: torch.device,
                 device_mesh=None, backend: Optional[str] = None):
        self.shape = {a: int(sizes[a]) for a in AXIS_ORDER}
        self.axis_names = AXIS_ORDER
        self.device = device
        self.device_mesh = device_mesh
        self.backend = backend
        # Axis -> its group's shared host memory when collectives stage
        # through the host (``collectives._Arena``), False for a group
        # whose ranks do not all run on one machine.
        self.arenas: Dict[str, object] = {}
        # True on a serving view whose work is every row of the batch on
        # each rank (``whole_rows``): JAX's ``batch`` axes split nothing.
        self.rows_whole = False

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def group(self, axis: str):
        """The process group of ``axis`` (None on an axis of size 1)."""
        if self.shape[axis] == 1:
            return None
        return self.device_mesh.get_group(axis)

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (JAX's ``lax.axis_index``)."""
        if self.shape[axis] == 1:
            return 0
        return int(self.device_mesh.get_local_rank(axis))

    def whole_rows(self) -> 'Mesh':
        """This mesh for work each rank does for every row of a serving
        batch (a prefill group, which every rank of ``data`` and ``fsdp``
        runs whole): every axis keeps its size, group, coordinate and
        arena, so the weights stay split as the mesh splits them, but the
        rows are not split over the batch axes."""
        view = Mesh(self.shape, self.device, self.device_mesh, self.backend)
        view.arenas = self.arenas
        view.rows_whole = True
        return view

    @property
    def stages_on_host(self) -> bool:
        """True when collectives on this mesh's device tensors go through
        host memory (gloo with CUDA tensors)."""
        return self.backend == 'gloo' and self.device.type == 'cuda'

    def __repr__(self) -> str:
        sizes = ', '.join(f'{a}={n}' for a, n in self.shape.items() if n > 1)
        return (f'Mesh({sizes or "one device"}, device={self.device}, '
                f'backend={self.backend})')


def backend_for(device_type: str, local_ranks: int) -> str:
    """The collective backend a gang's topology calls for: NCCL when the
    ranks compute on CUDA and every local rank has a GPU of its own, gloo
    when local ranks share a device or compute on the CPU. NCCL refuses
    two ranks on one device, so ranks that share a card reduce through
    gloo (host memory)."""
    if device_type == 'cuda' and torch.cuda.device_count() >= local_ranks:
        return 'nccl'
    return 'gloo'


def world_size() -> int:
    """Ranks in the default process group (1 when none is initialised)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def parse_spec(text: str) -> MeshSpec:
    """``"data=2,fsdp=-1"`` -> ``MeshSpec`` (``--mesh``, as JAX's
    ``train/run.py`` reads it)."""
    axes = {}
    for part in text.split(','):
        k, v = part.split('=')
        axes[k.strip()] = int(v)
    return MeshSpec(**axes)


def gang_devices(device_type: str) -> int:
    """The devices a ``-1`` axis resolves against, as JAX resolves it
    against ``len(jax.devices())``: the gang's host processes
    (``JAX_NUM_PROCESSES``) times each host's cards (one on the CPU)."""
    from skypilot_tpu_torch.parallel import gang
    local = torch.cuda.device_count() if device_type == 'cuda' else 1
    return gang.host_processes() * max(local, 1)


def resolve(spec: MeshSpec, n: int, num_slices: int = 1) -> Dict[str, int]:
    """``spec``'s axis sizes over ``n`` ranks; ``num_slices > 1``: the
    ``data`` axis must be a multiple of num_slices, so inter-slice
    traffic is data-parallel only (JAX's ``mesh.py:73-108`` errors)."""
    sizes = spec.resolve(n)
    if num_slices > 1:
        if sizes['data'] % num_slices:
            raise ValueError(
                f"data axis ({sizes['data']}) must be a multiple of "
                f'num_slices ({num_slices}) for DCN placement.')
        if n % num_slices:
            raise ValueError(f'{n} ranks do not split into {num_slices} '
                             'slices')
    return sizes


def build_mesh(spec: Optional[MeshSpec] = None, num_slices: int = 1,
               device=None) -> Mesh:
    """A mesh with all six logical axes (``AXIS_ORDER``) over the ranks of
    the default process group; ``device`` (default: CUDA) is where this
    rank computes. ``num_slices > 1``: see ``resolve``; the slices are
    contiguous blocks of ranks, so ``data``, outermost, is the only axis
    that crosses them."""
    from skypilot_tpu_torch.utils.device import resolve_device
    spec = spec or MeshSpec()
    n = world_size()
    sizes = resolve(spec, n, num_slices)
    dev = resolve_device(device)
    if n == 1:
        return Mesh(sizes, dev)
    from torch.distributed.device_mesh import init_device_mesh
    backend = dist.get_backend()
    # The mesh's device type is the collectives' medium: CUDA for NCCL,
    # the CPU for gloo (whose groups stage CUDA tensors through host
    # memory).
    device_mesh = init_device_mesh(
        'cuda' if backend == 'nccl' else 'cpu',
        tuple(sizes[a] for a in AXIS_ORDER), mesh_dim_names=AXIS_ORDER)
    return Mesh(sizes, dev, device_mesh, backend)


def single_device_mesh(device=None) -> Mesh:
    """1-device mesh with all axes size 1: the same code runs on one
    device and on a gang."""
    from skypilot_tpu_torch.utils.device import resolve_device
    return Mesh({a: 1 for a in AXIS_ORDER}, resolve_device(device))
