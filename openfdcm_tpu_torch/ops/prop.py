"""Kernel K3: orientation propagation of the DT3 stack.

Applies the reference's sequential schedule of 3·depth min-adds
``dt3[c2] = min(dt3[c2], dt3[c1] + w)`` (``dt3cpu.cpp:77-107``,
:func:`openfdcm_tpu_torch.matching.featuremap.propagation_steps`) to every
pixel of a ``(..., D, H, W)`` stack, in order, so results are bit-identical
to the unrolled chain.

Replaces ``openfdcm_tpu/ops/prop_kernel.py::propagate_orientation_tpu``
(Pallas ``_prop_kernel``).  CUDA source: ``csrc/prop.cu``.
"""
from __future__ import annotations

import torch

from . import build


def propagate_orientation_plain(dt3: torch.Tensor, steps) -> torch.Tensor:
    """Plain PyTorch version, any device: the unrolled chain on a copy."""
    out = dt3.clone()
    for c1, c2, w in steps:
        dst = out[..., c2, :, :]
        torch.minimum(dst, out[..., c1, :, :] + w, out=dst)
    return out


def propagate_orientation(dt3: torch.Tensor, steps) -> torch.Tensor:
    """K3 on a float32 ``(..., D, H, W)`` stack: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors.  ``steps``: sequence of
    ``(c1, c2, w)``."""
    if dt3.ndim < 3:
        raise ValueError(f"need a (..., D, H, W) stack, got {tuple(dt3.shape)}")
    build.require(dt3, "dt3", torch.float32, dt3.ndim)
    d, h, w = dt3.shape[-3:]
    if d > 96:
        raise ValueError(f"depth {d} exceeds the kernel's 96")
    if not all(0 <= s[0] < d and 0 <= s[1] < d for s in steps):
        raise ValueError("propagation step indices outside the depth axis")
    if not build.use_kernel(dt3):
        return propagate_orientation_plain(dt3, steps)
    n_stacks = dt3.numel() // (d * h * w) if dt3.numel() else 0
    out = torch.empty_like(dt3)
    if not n_stacks or not steps:
        out.copy_(dt3)
        return out
    c1 = torch.tensor([s[0] for s in steps], dtype=torch.int32, device=dt3.device)
    c2 = torch.tensor([s[1] for s in steps], dtype=torch.int32, device=dt3.device)
    wt = torch.tensor([s[2] for s in steps], dtype=torch.float32, device=dt3.device)
    build.launch("fdcm_prop", dt3.device, dt3.data_ptr(), out.data_ptr(),
                 c1.data_ptr(), c2.data_ptr(), wt.data_ptr(), len(steps), d,
                 h * w, n_stacks)
    propagate_orientation.launches += 1
    return out


propagate_orientation.launches = 0
