"""Device meshes and shardings (port of ``se_snmf_nat_tpu.parallel.mesh``).

The reference's mesh is a ``jax.sharding.Mesh``: devices in a grid with
named axes, over which GSPMD places the shards and emits the collectives.
Here a mesh is a plain object: a NumPy grid of ``torch.device``s, the axis
names, and optionally a ``torch.distributed`` process group that extends
one axis (``process_axis``) across processes.  A device may appear more
than once: its shards are then logical, several on one card, or the eight
CPU shards the tests use where the reference's use eight virtual CPU
devices.

A sharding splits one dimension of a tensor over one axis
(``data_sharding``, ``model_sharding``) or keeps it whole
(``replicated``).  A process cuts its shards in axis order over its own
devices.  With a process group each process holds its block of the global
tensor (the shards of its devices, in order): global shard
``rank * local + i``.

``psum`` is the one collective: it adds a process's shards in shard order
on the first shard's device, then all-reduces that sum over the group when
the group spans the axis.  Each call is one all-reduce for
``collectives_audit``'s recorder, whether or not it leaves the process.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from se_snmf_nat_tpu_torch.device import require_cuda
from se_snmf_nat_tpu_torch.parallel.collectives_audit import note


@dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: an object array of ``torch.device`` with this process's
    shape of the mesh; ``group``: the process group along
    ``process_axis`` (None: one process)."""
    devices: np.ndarray
    axis_names: tuple[str, ...]
    group: object = None
    process_axis: str = "data"

    @property
    def local_shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def shape(self) -> dict[str, int]:
        """Global axis sizes, like ``jax.sharding.Mesh.shape``."""
        shape = self.local_shape
        if self.group is not None:
            import torch.distributed as dist
            shape[self.process_axis] *= dist.get_world_size(self.group)
        return shape

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    def crosses(self, axis: str) -> bool:
        """Whether ``axis`` leaves this process."""
        return self.group is not None and axis == self.process_axis

    def shard_offset(self, axis: str) -> int:
        """The global index of this process's first shard along ``axis``."""
        if not self.crosses(axis):
            return 0
        import torch.distributed as dist
        return dist.get_rank(self.group) * self.local_shape[axis]

    def axis_devices(self, axis: str) -> list[torch.device]:
        """This process's devices along ``axis`` (the first along every
        other axis), one a shard."""
        k = self.axis_names.index(axis)
        index = [0] * self.devices.ndim
        out = []
        for i in range(self.devices.shape[k]):
            index[k] = i
            out.append(self.devices[tuple(index)])
        return out

    def device_blocks(self, axis: str | None,
                      n: int) -> list[tuple[torch.device, slice]]:
        """``n`` items split evenly over the shards of ``axis`` (of every
        device of this process, in order, for None) and merged where
        consecutive shards share a device: (device, slice) pairs, so
        logical shards on one card run as one call."""
        devs = (list(self.devices.flat) if axis is None
                else self.axis_devices(axis))
        if n % len(devs):
            raise ValueError(f"{n} does not split over the {len(devs)} "
                             f"shards of axis {axis!r}")
        per = n // len(devs)
        blocks: list[tuple[torch.device, slice]] = []
        for i, dev in enumerate(devs):
            if blocks and blocks[-1][0] == dev:
                blocks[-1] = (dev, slice(blocks[-1][1].start,
                                         (i + 1) * per))
            else:
                blocks.append((dev, slice(i * per, (i + 1) * per)))
        return blocks


def make_mesh(shape: tuple[int, ...] | None = None,
              axes: tuple[str, ...] = ("data", "model"), devices=None,
              group=None, process_axis: str = "data") -> Mesh:
    """A mesh over ``devices`` (default: every card of this process; a
    device may repeat for logical shards, ``["cpu"] * 8`` on the CPU).

    Default shape: all devices on the first axis, the others trivial, the
    layout of utterance-parallel enhancement.  ``group`` extends
    ``process_axis`` over the processes of a ``torch.distributed`` group
    (``parallel.distributed.init_multihost``)."""
    if devices is None:
        require_cuda()
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if shape is None:
        shape = (n,) + (1,) * (len(axes) - 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(shape), tuple(axes), group, process_axis)


@dataclass(frozen=True)
class Sharding:
    """``spec``: an axis name or None for each dimension of a tensor (at
    most one named)."""
    mesh: Mesh
    spec: tuple

    def _dim(self):
        named = [(d, a) for d, a in enumerate(self.spec) if a is not None]
        if len(named) > 1:
            raise ValueError(f"one sharded dimension at most: {self.spec}")
        return named[0] if named else (None, None)

    def split(self, t: torch.Tensor) -> list[torch.Tensor]:
        """This process's shards of ``t`` (its block of the global tensor
        under a process group), each on its shard's device; a replicated
        tensor is one part."""
        dim, axis = self._dim()
        if dim is None:
            return [t]
        devs = self.mesh.axis_devices(axis)
        if t.shape[dim] % len(devs):
            raise ValueError(f"dimension {dim} of size {t.shape[dim]} does "
                             f"not split over the {len(devs)} shards of "
                             f"axis {axis!r}")
        return [p.to(d) for p, d in zip(torch.chunk(t, len(devs), dim),
                                        devs)]

    def join(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """The inverse of ``split``, on the first shard's device."""
        dim, _ = self._dim()
        if dim is None:
            return parts[0]
        dev = parts[0].device
        return torch.cat([p.to(dev) for p in parts], dim)


def data_sharding(mesh: Mesh, ndim: int, data_dim: int = 0) -> Sharding:
    """Shard dimension ``data_dim`` over 'data', replicate the rest."""
    spec = [None] * ndim
    spec[data_dim] = "data"
    return Sharding(mesh, tuple(spec))


def model_sharding(mesh: Mesh, ndim: int, model_dim: int) -> Sharding:
    spec = [None] * ndim
    spec[model_dim] = "model"
    return Sharding(mesh, tuple(spec))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def psum(parts: list[torch.Tensor], mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum over every shard of ``axis``: this process's ``parts`` added
    in shard order on the first part's device, then all-reduced over the
    mesh's group when the group spans ``axis``."""
    total = parts[0].clone()
    for p in parts[1:]:
        total = total + p.to(total.device)
    note("all-reduce", total)
    if mesh.crosses(axis):
        import torch.distributed as dist
        dist.all_reduce(total, group=mesh.group)
    return total
