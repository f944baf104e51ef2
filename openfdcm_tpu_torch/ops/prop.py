"""Kernel K3: orientation propagation of the DT3 stack, in place.

Applies the reference's sequential schedule of min-adds
``dt3[c2] = min(dt3[c2], dt3[c1] + w)`` (``dt3cpu.cpp:77-107``,
:func:`openfdcm_tpu_torch.matching.featuremap.propagation_steps`) to every
pixel of a ``(..., D, H, W)`` stack, in order, so results are bit-identical
to the unrolled chain.

The wrapper updates the stack it is given and returns it, on every device:
the DT3 build hands it a temporary that nothing else reads.  Any depth and
any step list are taken.  On a CUDA tensor the kernel runs with its step
indices fixed at compile time where the step list is the reference's
pattern (:func:`reference_pattern`) and the depth 12, 30 or 60; any other
list of at most :data:`MAX_STEPS` steps on a depth up to :data:`MAX_DEPTH`
runs ``prop_any``, which takes the steps as a kernel parameter.  Deeper
stacks or longer lists run :func:`propagate_orientation_shared` (the steps
in a device table, each pixel's vector in shared memory) up to
:data:`MAX_SHARED_DEPTH`, and :func:`propagate_orientation_global` (in
place on device memory) beyond it; :func:`variant` makes the choice.  These
three carry the chain of the step list in a register
(:func:`chain_flags`) and read the other operands :func:`read_ahead` steps
ahead.

Replaces ``openfdcm_tpu/ops/prop_kernel.py::propagate_orientation_tpu``
(Pallas ``_prop_kernel``).  CUDA source: ``csrc/prop.cu``.
"""
from __future__ import annotations

import ctypes
import functools
import itertools
import math

import numpy as np
import torch

from . import build

# the general kernel's step list, a kernel parameter
MAX_DEPTH, MAX_STEPS = 96, 384
# the deepest vector 32 threads hold in a Hopper block's 227 KB of opt-in
# shared memory (prop_shared); deeper stacks run prop_global
MAX_SHARED_DEPTH = 232448 // (32 * 4)


def reference_pattern(depth: int) -> list[tuple[int, int]]:
    """The ``(c1, c2)`` pattern ``prop_fixed<depth>`` unrolls: forward
    ``c-1 -> c`` for ``c < ceil(1.5 D)``, then backward ``c+1 -> c`` for
    ``c`` from ``D`` down to ``-floor(1.5 D) + 1``, indices mod ``D``."""
    fwd = [((c - 1) % depth, c % depth) for c in range(math.ceil(1.5 * depth))]
    bwd = [((c + 1) % depth, c % depth)
           for c in range(depth, -math.floor(1.5 * depth), -1)]
    return fwd + bwd


# the read-ahead depths the kernels are built for, deepest first
READ_AHEAD = (8, 4, 2, 1)


def step_table(steps) -> np.ndarray:
    """The ``(3, n)`` int32 table the kernels read: ``c1``, ``c2`` and the
    weights rounded to f32, as bits."""
    a = np.fromiter(itertools.chain.from_iterable(steps), np.float64,
                    count=3 * len(steps)).reshape(-1, 3)
    return np.stack([a[:, 0].astype(np.int32), a[:, 1].astype(np.int32),
                     a[:, 2].astype(np.float32).view(np.int32)])


def _chain(c1: np.ndarray, c2: np.ndarray) -> np.ndarray:
    flags = np.zeros(len(c1), bool)
    flags[1:] = c1[1:] == c2[:-1]
    return flags


def _revisit(c1: np.ndarray, c2: np.ndarray) -> int:
    chain = _chain(c1, c2)
    last, least = {}, len(c1)
    for k, (a, b) in enumerate(zip(c1.tolist(), c2.tolist())):
        for c in (b,) if chain[k] else (a, b):
            if c in last:
                least = min(least, k - last[c])
        last[b] = k
    return max(least, 1)


def chain_flags(steps) -> np.ndarray:
    """Per step, whether it reads the index the step before it wrote
    (``c1[k] == c2[k - 1]``): the kernels take that operand from a
    register, the value they have just written."""
    table = step_table(steps)
    return _chain(table[0], table[1])


def revisit_distance(steps) -> int:
    """The fewest steps from a step's write of an index to a later step's
    read of it from memory: ``c2`` of every step, ``c1`` of a step that is
    not chained (:func:`chain_flags`); ``len(steps)`` when no step reads an
    index written before it."""
    table = step_table(steps)
    return _revisit(table[0], table[1])


def read_ahead(steps) -> int:
    """How many steps ahead the kernels may read a step's operands: the
    largest of :data:`READ_AHEAD` no larger than :func:`revisit_distance`
    (a read ``L`` steps ahead misses the writes of the ``L - 1`` steps
    between)."""
    table = step_table(steps)
    return _read_ahead(table.tobytes(), table.shape[1])


@functools.lru_cache(maxsize=64)
def _read_ahead(key: bytes, n: int) -> int:
    """:func:`read_ahead` of the step table with bytes ``key``: a build
    passes the same list every time."""
    table = np.frombuffer(key, np.int32).reshape(3, n)
    least = _revisit(table[0], table[1])
    return next(a for a in READ_AHEAD if a <= least)


@functools.lru_cache(maxsize=16)
def _device_table(key: bytes, n: int, device: torch.device) -> torch.Tensor:
    """The step table with bytes ``key`` on ``device``, copied there once."""
    return torch.frombuffer(bytearray(key), dtype=torch.int32).reshape(3, n).to(device)


def propagate_orientation_plain(dt3: torch.Tensor, steps) -> torch.Tensor:
    """Plain PyTorch version, any device: the unrolled chain on a copy."""
    out = dt3.clone()
    for c1, c2, w in steps:
        dst = out[..., c2, :, :]
        torch.minimum(dst, out[..., c1, :, :] + w, out=dst)
    return out


def variant(depth: int, n_steps: int) -> str:
    """The kernel a CUDA stack of ``depth`` orientations and ``n_steps``
    steps runs: ``"param"`` (the steps a kernel parameter), ``"shared"`` or
    ``"global"``."""
    if depth <= MAX_DEPTH and n_steps <= MAX_STEPS:
        return "param"
    return "shared" if depth <= MAX_SHARED_DEPTH else "global"


def _check(dt3: torch.Tensor, steps) -> np.ndarray:
    """Raise unless ``dt3`` is a float32 ``(..., D, H, W)`` stack and every
    step index lies on its depth axis; returns the :func:`step_table`."""
    if dt3.ndim < 3:
        raise ValueError(f"need a (..., D, H, W) stack, got {tuple(dt3.shape)}")
    build.require(dt3, "dt3", torch.float32, dt3.ndim)
    d = dt3.shape[-3]
    table = step_table(steps)
    if ((table[:2] < 0) | (table[:2] >= d)).any():
        raise ValueError("propagation step indices outside the depth axis")
    return table


def _stacks(dt3: torch.Tensor) -> int:
    d, h, w = dt3.shape[-3:]
    return dt3.numel() // (d * h * w) if dt3.numel() else 0


def propagate_orientation(dt3: torch.Tensor, steps) -> torch.Tensor:
    """K3 on a float32 ``(..., D, H, W)`` stack, in place; returns ``dt3``.
    ``steps``: sequence of ``(c1, c2, w)``.  The CUDA kernel of
    :func:`variant` for CUDA tensors, the plain version (copied back) for
    CPU tensors.  ``launches`` counts its launches of ``prop_fixed`` and
    ``prop_any``, ``any_launches`` those of ``prop_any`` alone."""
    table = _check(dt3, steps)
    if not build.use_kernel(dt3):
        return dt3.copy_(propagate_orientation_plain(dt3, steps))
    d, h, w = dt3.shape[-3:]
    kind = variant(d, table.shape[1])
    if kind != "param":
        wide = propagate_orientation_shared if kind == "shared" \
            else propagate_orientation_global
        return wide(dt3, steps)
    n_stacks = _stacks(dt3)
    if not n_stacks or not table.shape[1]:
        return dt3
    general = ctypes.c_int(0)
    build.launch("fdcm_prop", dt3.device, dt3.data_ptr(), table[0].ctypes.data,
                 table[1].ctypes.data, table[2].ctypes.data, table.shape[1], d,
                 h * w, n_stacks, _read_ahead(table.tobytes(), table.shape[1]),
                 ctypes.addressof(general))
    propagate_orientation.launches += 1
    propagate_orientation.any_launches += general.value
    return dt3


def _launch_table(dt3: torch.Tensor, table: np.ndarray, shared: bool) -> bool:
    """Launch ``fdcm_prop_table`` on ``dt3`` with the step table on the
    device; ``False`` when there was nothing to do."""
    d, h, w = dt3.shape[-3:]
    n_stacks, n = _stacks(dt3), table.shape[1]
    if not n_stacks or not n:
        return False
    key = table.tobytes()
    build.launch("fdcm_prop_table", dt3.device, dt3.data_ptr(),
                 _device_table(key, n, dt3.device).data_ptr(), n, d, h * w,
                 n_stacks, int(shared), _read_ahead(key, n))
    return True


def propagate_orientation_shared(dt3: torch.Tensor, steps) -> torch.Tensor:
    """K3's ``prop_shared`` on a stack of at most :data:`MAX_SHARED_DEPTH`
    orientations, any step list, in place; returns ``dt3``.  The plain
    version (copied back) for CPU tensors."""
    table = _check(dt3, steps)
    d = dt3.shape[-3]
    if d > MAX_SHARED_DEPTH:
        raise ValueError(f"depth {d}: prop_shared holds at most "
                         f"{MAX_SHARED_DEPTH} orientations")
    if not build.use_kernel(dt3):
        return dt3.copy_(propagate_orientation_plain(dt3, steps))
    if _launch_table(dt3, table, shared=True):
        propagate_orientation_shared.launches += 1
    return dt3


def propagate_orientation_global(dt3: torch.Tensor, steps) -> torch.Tensor:
    """K3's ``prop_global`` (in place on device memory) on a stack of any
    depth and any step list; returns ``dt3``.  The plain version (copied
    back) for CPU tensors."""
    table = _check(dt3, steps)
    if not build.use_kernel(dt3):
        return dt3.copy_(propagate_orientation_plain(dt3, steps))
    if _launch_table(dt3, table, shared=False):
        propagate_orientation_global.launches += 1
    return dt3


propagate_orientation.launches = 0
propagate_orientation.any_launches = 0
propagate_orientation_shared.launches = 0
propagate_orientation_global.launches = 0
