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
runs its general kernel, which takes the steps as a kernel parameter.
Deeper stacks or longer lists run :func:`propagate_orientation_shared`
(the steps in a device table, each pixel's vector in shared memory) up to
:data:`MAX_SHARED_DEPTH`, and :func:`propagate_orientation_global` (in
place on device memory) beyond it; :func:`variant` makes the choice.

Replaces ``openfdcm_tpu/ops/prop_kernel.py::propagate_orientation_tpu``
(Pallas ``_prop_kernel``).  CUDA source: ``csrc/prop.cu``.
"""
from __future__ import annotations

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


def _check(dt3: torch.Tensor, steps) -> int:
    """Raise unless ``dt3`` is a float32 ``(..., D, H, W)`` stack and every
    step index lies on its depth axis; returns ``D``."""
    if dt3.ndim < 3:
        raise ValueError(f"need a (..., D, H, W) stack, got {tuple(dt3.shape)}")
    build.require(dt3, "dt3", torch.float32, dt3.ndim)
    d = dt3.shape[-3]
    if not all(0 <= s[0] < d and 0 <= s[1] < d for s in steps):
        raise ValueError("propagation step indices outside the depth axis")
    return d


def propagate_orientation(dt3: torch.Tensor, steps) -> torch.Tensor:
    """K3 on a float32 ``(..., D, H, W)`` stack, in place; returns ``dt3``.
    ``steps``: sequence of ``(c1, c2, w)``.  The CUDA kernel of
    :func:`variant` for CUDA tensors, the plain version (copied back) for
    CPU tensors."""
    d = _check(dt3, steps)
    if not build.use_kernel(dt3):
        return dt3.copy_(propagate_orientation_plain(dt3, steps))
    kind = variant(d, len(steps))
    if kind != "param":
        wide = propagate_orientation_shared if kind == "shared" \
            else propagate_orientation_global
        return wide(dt3, steps)
    h, w = dt3.shape[-2:]
    n_stacks = dt3.numel() // (d * h * w) if dt3.numel() else 0
    if not n_stacks or not steps:
        return dt3
    c1 = np.array([s[0] for s in steps], np.int32)
    c2 = np.array([s[1] for s in steps], np.int32)
    wt = np.array([s[2] for s in steps], np.float32)
    build.launch("fdcm_prop", dt3.device, dt3.data_ptr(), c1.ctypes.data,
                 c2.ctypes.data, wt.ctypes.data, len(steps), d, h * w, n_stacks)
    propagate_orientation.launches += 1
    return dt3


def _launch_table(dt3: torch.Tensor, steps, shared: bool) -> bool:
    """Launch ``fdcm_prop_table`` on ``dt3`` with ``steps`` as a device
    table; ``False`` when there was nothing to do."""
    d, h, w = dt3.shape[-3:]
    n_stacks = dt3.numel() // (d * h * w) if dt3.numel() else 0
    if not n_stacks or not steps:
        return False
    table = np.stack([np.array([s[0] for s in steps], np.int32),
                      np.array([s[1] for s in steps], np.int32),
                      np.array([s[2] for s in steps], np.float32).view(np.int32)])
    table = torch.from_numpy(table).to(dt3.device)
    build.launch("fdcm_prop_table", dt3.device, dt3.data_ptr(), table.data_ptr(),
                 len(steps), d, h * w, n_stacks, int(shared))
    return True


def propagate_orientation_shared(dt3: torch.Tensor, steps) -> torch.Tensor:
    """K3's ``prop_shared`` on a stack of at most :data:`MAX_SHARED_DEPTH`
    orientations, any step list, in place; returns ``dt3``.  The plain
    version (copied back) for CPU tensors."""
    d = _check(dt3, steps)
    if d > MAX_SHARED_DEPTH:
        raise ValueError(f"depth {d}: prop_shared holds at most "
                         f"{MAX_SHARED_DEPTH} orientations")
    if not build.use_kernel(dt3):
        return dt3.copy_(propagate_orientation_plain(dt3, steps))
    if _launch_table(dt3, steps, shared=True):
        propagate_orientation_shared.launches += 1
    return dt3


def propagate_orientation_global(dt3: torch.Tensor, steps) -> torch.Tensor:
    """K3's ``prop_global`` (in place on device memory) on a stack of any
    depth and any step list; returns ``dt3``.  The plain version (copied
    back) for CPU tensors."""
    _check(dt3, steps)
    if not build.use_kernel(dt3):
        return dt3.copy_(propagate_orientation_plain(dt3, steps))
    if _launch_table(dt3, steps, shared=False):
        propagate_orientation_global.launches += 1
    return dt3


propagate_orientation.launches = 0
propagate_orientation_shared.launches = 0
propagate_orientation_global.launches = 0
