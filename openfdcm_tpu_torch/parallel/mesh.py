"""A device mesh (the port's counterpart of ``jax.sharding.Mesh`` plus
``shard_map``).

A :class:`Mesh` is a named grid of ``torch.device`` entries, each owned by
a process (its ``processes`` grid, like a JAX device's
``process_index``).  A mesh whose entries all belong to this process runs
under one controller: the process runs every shard's local function
itself, in mesh order, with that shard's tensors on its entry's device.
The collectives are explicit copies:

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

A mesh whose entries name other processes spans processes (the JAX
multi-controller runtime, on ``torch.distributed``: :mod:`.distributed`).
Every process holds the same mesh and makes the same calls; each runs the
shards of its own entries (:meth:`Mesh.own_entries`), and a collective
along a line that spans processes takes ``owners=`` (the line's
processes, :meth:`Mesh.owners`): each owner passes its own parts and
``None`` for the others', and the owners exchange what each needs.  The
entry points that run under one controller (``match_many`` and the rest,
as in the JAX package) refuse such a mesh (:meth:`Mesh.require_local`).
"""
from __future__ import annotations

import dataclasses
import threading
import weakref

import numpy as np
import torch

from ..core.types import resolve_device
from .distributed import exchange, process_index


class Mesh:
    """A grid of devices with one name per axis.  ``devices``: an object
    ndarray of ``torch.device`` (or anything ``torch.device`` takes);
    ``processes``: the rank that owns each entry, an integer array of the
    same shape (None: this process owns every entry); ``shape`` is a dict
    ``{axis name: size}``, as in JAX."""

    def __init__(self, devices, axis_names, processes=None):
        grid = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if grid.ndim != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh of shape {grid.shape}: need one distinct "
                             f"name per axis, got {axis_names}")
        flat = np.empty(grid.size, dtype=object)
        flat[:] = [torch.device(d) for d in grid.reshape(-1)]
        self.devices = flat.reshape(grid.shape)
        self.processes = (np.full(grid.shape, process_index()) if processes is None
                          else np.asarray(processes, dtype=np.int64))
        if self.processes.shape != grid.shape or (self.processes < 0).any():
            raise ValueError(f"processes of shape {self.processes.shape} for a "
                             f"mesh of shape {grid.shape}: need a rank >= 0 "
                             f"for each entry")
        self.axis_names = axis_names
        self._replicas = {}
        self._replicas_lock = threading.Lock()    # a service's thread shares it

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_size(self, axis: str) -> int:
        """Entries along ``axis``; 1 for an axis the mesh does not have."""
        return self.shape.get(axis, 1)

    def _at(self, coords) -> tuple:
        for name, i in coords.items():
            if name not in self.axis_names and i != 0:
                raise ValueError(f"mesh {self.axis_names} has no axis {name!r}")
        return tuple(coords.get(n, 0) for n in self.axis_names)

    def device(self, **coords) -> torch.device:
        """The entry at ``coords`` (axis name -> index; an axis left out, or
        one the mesh does not have, at index 0)."""
        return self.devices[self._at(coords)]

    def process(self, **coords) -> int:
        """The rank that owns the entry at ``coords`` (as :meth:`device`)."""
        return int(self.processes[self._at(coords)])

    def along(self, axis: str, **coords) -> list:
        """The entries along ``axis`` at ``coords`` of the other axes."""
        return [self.device(**{**coords, axis: i}) for i in range(self.axis_size(axis))]

    def owners(self, axis: str, **coords) -> list:
        """The ranks that own the entries of :meth:`along`."""
        return [self.process(**{**coords, axis: i}) for i in range(self.axis_size(axis))]

    @property
    def local(self) -> bool:
        """Whether this process owns every entry (one controller)."""
        return bool((self.processes == process_index()).all())

    def own_entries(self) -> list:
        """``(coords, device)`` of this process's entries, in mesh order."""
        me = process_index()
        return [(dict(zip(self.axis_names, ix)), self.devices[ix])
                for ix in np.ndindex(*self.devices.shape)
                if self.processes[ix] == me]

    def require_local(self, what: str) -> None:
        """Raise ``ValueError`` unless this process owns every entry: ``what``
        runs under one controller, as in the JAX package (whose
        ``match_many`` on a mesh over two processes fails fetching a value
        "that spans non-addressable (non process local) devices")."""
        if not self.local:
            raise ValueError(
                f"{what} runs under one controller, as in the JAX package: "
                f"it takes a mesh of this process's devices only, and this "
                f"mesh's entries belong to processes "
                f"{sorted(set(self.processes.reshape(-1).tolist()))} (this is "
                f"process {process_index()})")

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
                tuple(str(d) for d in self.devices.reshape(-1)),
                tuple(self.processes.reshape(-1).tolist()))

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        procs = sorted(set(self.processes.reshape(-1).tolist()))
        return (f"Mesh({self.shape}, devices={[str(d) for d in self.distinct()]}"
                + ("" if self.local else f", processes={procs}") + ")")

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
    def all_gather(parts, device, dim: int = 0, owners=None) -> torch.Tensor:
        """The parts concatenated along ``dim`` in shard order on ``device``.
        ``owners``: the rank of each part, for a line that spans processes
        (each owner passes ``None`` for the others' parts and gets the
        whole)."""
        return torch.cat([p.to(device) for p in _fill(parts, owners)], dim=dim)

    @staticmethod
    def ppermute(x: torch.Tensor, device, owners=None) -> torch.Tensor:
        """``x`` moved to the next block's ``device``.  ``owners``: the
        (sending, receiving) ranks, where they differ: the sender passes
        ``x`` and gets None, the receiver passes None and gets ``x``."""
        if owners is None or owners[0] == owners[1]:
            return x.to(device)
        me, (src, dst) = process_index(), owners
        if me == src:
            exchange({dst: [x]})
            return None
        if me != dst:
            raise ValueError(f"process {me} is neither sender nor receiver "
                             f"of {tuple(owners)}")
        return exchange({src: []})[src][0].to(device)

    @staticmethod
    def psum(parts, device, owners=None) -> torch.Tensor:
        """The parts summed in shard order on ``device`` (``owners`` as in
        :meth:`all_gather`: every owner gets the same sum)."""
        parts = _fill(parts, owners)
        acc = parts[0].to(device)
        for p in parts[1:]:
            acc = acc + p.to(device)
        return acc

    @staticmethod
    def all_to_all(blocks, split_dim: int, concat_dim: int, devices,
                   owners=None) -> list:
        """Re-slice ``blocks`` (one per shard): each block is split into
        ``len(devices)`` equal pieces along ``split_dim``, and block ``j`` of
        the result is piece ``j`` of every block, concatenated along
        ``concat_dim`` in shard order, on ``devices[j]``.  ``owners``: the
        rank of each block, for a line that spans processes: each owner
        passes ``None`` for the others' blocks, sends each owner the pieces
        it needs, and gets its own blocks of the result (None for the
        others')."""
        n = len(devices)
        pieces = [None if b is None else b.chunk(n, split_dim) for b in blocks]
        me = process_index()
        mine = [j for j in range(n) if owners is None or owners[j] == me]
        peers = sorted(set(owners or ()) - {me})
        if peers:
            theirs = {q: [j for j in range(n) if owners[j] == q] for q in peers}
            got = exchange({q: [pieces[i][j] for i in mine for j in theirs[q]]
                            for q in peers})
            for q in peers:
                received = iter(got[q])
                for i in theirs[q]:
                    pieces[i] = {j: next(received) for j in mine}
        return [torch.cat([p[j].to(devices[j]) for p in pieces], dim=concat_dim)
                if j in mine else None for j in range(n)]


def _fill(parts, owners) -> list:
    """``parts`` with the parts of other processes (``None`` here) filled in
    from their owners: every owner sends its own parts, in shard order, to
    every other owner.  A no-op where ``owners`` is None or names only this
    process."""
    me = process_index()
    peers = sorted(set(owners or ()) - {me})
    if not peers:
        return list(parts)
    if len(owners) != len(parts) or any(
            (p is None) != (o != me) for p, o in zip(parts, owners)):
        raise ValueError(f"process {me} must pass its own parts and None for "
                         f"the others' (owners {list(owners)})")
    got = exchange({q: [p for p in parts if p is not None] for q in peers})
    received = {q: iter(got[q]) for q in peers}
    return [p if o == me else next(received[o]) for p, o in zip(parts, owners)]


@dataclasses.dataclass(frozen=True)
class Shard:
    """One block of a :class:`ShardedTensor` (JAX ``jax.Shard``): ``index``
    the block's slices into the whole, ``data`` the block on ``device``."""
    index: tuple
    data: torch.Tensor
    device: torch.device


@dataclasses.dataclass(frozen=True)
class ShardedTensor:
    """A tensor split over a mesh that spans processes, as this process
    holds it (the port's counterpart of a sharded ``jax.Array``): ``shape``
    the whole tensor's, ``addressable_shards`` this process's
    :class:`Shard` s, one per entry it owns, in mesh order."""
    shape: tuple
    addressable_shards: list
