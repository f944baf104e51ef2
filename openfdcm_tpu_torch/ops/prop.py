"""Kernel K3: orientation propagation of the DT3 stack, in place.

Applies the reference's sequential schedule of min-adds
``dt3[c2] = min(dt3[c2], dt3[c1] + w)`` (``dt3cpu.cpp:77-107``,
:func:`openfdcm_tpu_torch.matching.featuremap.propagation_steps`) to every
pixel of a ``(..., D, H, W)`` stack, in order, so results are bit-identical
to the unrolled chain.

The wrapper updates the stack it is given and returns it, on every device:
the DT3 build hands it a temporary that nothing else reads.  On a CUDA
tensor the kernel runs with its step indices fixed at compile time where
the step list is the reference's pattern (:func:`reference_pattern`) and
the depth 12, 30 or 60; any other list of at most
:data:`MAX_STEPS` steps on a depth up to 96 runs its general kernel.

Replaces ``openfdcm_tpu/ops/prop_kernel.py::propagate_orientation_tpu``
(Pallas ``_prop_kernel``).  CUDA source: ``csrc/prop.cu``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import build

MAX_DEPTH, MAX_STEPS = 96, 384


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


def propagate_orientation(dt3: torch.Tensor, steps) -> torch.Tensor:
    """K3 on a float32 ``(..., D, H, W)`` stack, in place; returns ``dt3``.
    ``steps``: sequence of ``(c1, c2, w)``.  The CUDA kernel for CUDA
    tensors, the plain version (copied back) for CPU tensors."""
    if dt3.ndim < 3:
        raise ValueError(f"need a (..., D, H, W) stack, got {tuple(dt3.shape)}")
    build.require(dt3, "dt3", torch.float32, dt3.ndim)
    d, h, w = dt3.shape[-3:]
    if d > MAX_DEPTH or len(steps) > MAX_STEPS:
        raise ValueError(f"depth {d} or {len(steps)} steps exceed the kernel's "
                         f"{MAX_DEPTH} and {MAX_STEPS}")
    if not all(0 <= s[0] < d and 0 <= s[1] < d for s in steps):
        raise ValueError("propagation step indices outside the depth axis")
    if not build.use_kernel(dt3):
        return dt3.copy_(propagate_orientation_plain(dt3, steps))
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


propagate_orientation.launches = 0
