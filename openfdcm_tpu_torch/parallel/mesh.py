"""A single-controller device mesh (the port's counterpart of
``jax.sharding.Mesh`` plus ``shard_map``).

One process holds a :class:`Mesh`, a named grid of ``torch.device``
entries, and runs every shard's local function itself, in mesh order, with
that shard's tensors on its entry's device.  The collectives are explicit
copies:

- :meth:`Mesh.all_gather`: ``.to()`` onto the gathering device, then a
  concatenation in shard order;
- :meth:`Mesh.ppermute`: one carry moved to the next block's device;
- :meth:`Mesh.all_to_all`: blocks split along one axis and re-sliced along
  another;
- :meth:`Mesh.psum`: values summed in shard order (``0 + v + 0 ...`` is
  exact where one shard holds the value, which the row-sharded search
  relies on).

An entry may repeat a device: a mesh of ``[cuda:0] * n`` runs every shard
on one card, which tests the sharding on one card without showing that it
scales.  There are no per-device threads or streams.
"""
from __future__ import annotations

import threading
import weakref

import numpy as np
import torch

from ..core.types import resolve_device


class Mesh:
    """A grid of devices with one name per axis.  ``devices``: an object
    ndarray of ``torch.device`` (or anything ``torch.device`` takes);
    ``shape`` is a dict ``{axis name: size}``, as in JAX."""

    def __init__(self, devices, axis_names):
        grid = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if grid.ndim != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh of shape {grid.shape}: need one distinct "
                             f"name per axis, got {axis_names}")
        flat = np.empty(grid.size, dtype=object)
        flat[:] = [torch.device(d) for d in grid.reshape(-1)]
        self.devices = flat.reshape(grid.shape)
        self.axis_names = axis_names
        self._replicas = {}
        self._replicas_lock = threading.Lock()    # a service's thread shares it

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_size(self, axis: str) -> int:
        """Entries along ``axis``; 1 for an axis the mesh does not have."""
        return self.shape.get(axis, 1)

    def device(self, **coords) -> torch.device:
        """The entry at ``coords`` (axis name -> index; an axis left out, or
        one the mesh does not have, at index 0)."""
        for name, i in coords.items():
            if name not in self.axis_names and i != 0:
                raise ValueError(f"mesh {self.axis_names} has no axis {name!r}")
        return self.devices[tuple(coords.get(n, 0) for n in self.axis_names)]

    def along(self, axis: str, **coords) -> list:
        """The entries along ``axis`` at ``coords`` of the other axes."""
        return [self.device(**{**coords, axis: i}) for i in range(self.axis_size(axis))]

    def distinct(self) -> list:
        """The distinct devices of the mesh, in mesh order."""
        out = []
        for d in self.devices.reshape(-1):
            if d not in out:
                out.append(d)
        return out

    def resolve(self, device=None) -> torch.device:
        """The gathering device of a call that got this mesh and ``device``:
        the mesh's first entry when ``device`` is None, else ``device``,
        which must be one of the mesh's devices."""
        if device is None:
            return self.devices.reshape(-1)[0]
        dev = resolve_device(device)
        if dev not in self.distinct():
            raise ValueError(f"device {dev} is not in the mesh "
                             f"{[str(d) for d in self.distinct()]}")
        return dev

    def replica(self, t: torch.Tensor, device) -> torch.Tensor:
        """``t`` on ``device``, copied once per (tensor, device) for as long
        as ``t`` lives: the template bank's tables, replicated on each
        distinct device of the mesh by the first call that needs them."""
        if t.device == device:
            return t
        with self._replicas_lock:
            entry = self._replicas.get(id(t))
            if entry is None or entry[0]() is not t:
                entry = self._replicas[id(t)] = (weakref.ref(t), {})
                weakref.finalize(t, self._replicas.pop, id(t), None)
            if device not in entry[1]:
                entry[1][device] = t.to(device)
            return entry[1][device]

    def _key(self):
        return (self.axis_names, self.devices.shape,
                tuple(str(d) for d in self.devices.reshape(-1)))

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return f"Mesh({self.shape}, devices={[str(d) for d in self.distinct()]})"

    # -- collectives ----------------------------------------------------
    @staticmethod
    def split(x: torch.Tensor, devices, dim: int = 0) -> list:
        """``x`` in ``len(devices)`` equal blocks along ``dim``, block ``i``
        on ``devices[i]``."""
        n = len(devices)
        if x.shape[dim] % n:
            raise ValueError(f"axis of size {x.shape[dim]} does not split "
                             f"into {n} equal blocks")
        return [b.to(d) for b, d in zip(x.chunk(n, dim) if x.shape[dim] else
                                        [x] * n, devices)]

    @staticmethod
    def all_gather(parts, device, dim: int = 0) -> torch.Tensor:
        """The parts concatenated along ``dim`` in shard order on ``device``."""
        return torch.cat([p.to(device) for p in parts], dim=dim)

    @staticmethod
    def ppermute(x: torch.Tensor, device) -> torch.Tensor:
        """``x`` moved to the next block's ``device``."""
        return x.to(device)

    @staticmethod
    def psum(parts, device) -> torch.Tensor:
        """The parts summed in shard order on ``device``."""
        acc = parts[0].to(device)
        for p in parts[1:]:
            acc = acc + p.to(device)
        return acc

    @staticmethod
    def all_to_all(blocks, split_dim: int, concat_dim: int, devices) -> list:
        """Re-slice ``blocks`` (one per shard): each block is split into
        ``len(devices)`` equal pieces along ``split_dim``, and block ``j`` of
        the result is piece ``j`` of every block, concatenated along
        ``concat_dim`` in shard order, on ``devices[j]``."""
        n = len(devices)
        pieces = [b.chunk(n, split_dim) for b in blocks]
        return [torch.cat([p[j].to(devices[j]) for p in pieces], dim=concat_dim)
                for j in range(n)]
