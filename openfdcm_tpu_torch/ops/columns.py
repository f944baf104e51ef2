"""The column pass of the distance transform, in one launch.

``out[..., y, x] = min_y' (f[..., y', x] + |y - y'|)`` along H of a float32
``(..., H, W)`` stack, as the cumulative-min identity of the plain version
:func:`openfdcm_tpu_torch.core.dt._nearest_1d_l1` ``(f, dim=-2)`` computes
it; the kernel is bit-equal to it for every float32 input (NaN and ±inf
included).

Replaces no TPU kernel: the JAX package runs ``lax.cummin`` here.  In eager
PyTorch the plain version makes about 23 stack-sized passes through device
memory (two ``cummin`` calls that also write int64 indices, two flips, five
elementwise passes) and holds six stack-sized tensors at once.  The kernel
reads the stack twice and writes it once (12 bytes a pixel), with a scratch
of one entry a column and :data:`CHUNK` rows.  CUDA source:
``csrc/columns.cu`` (a block a strip of 64 columns, a thread a column, chunks
through shared memory).
"""
from __future__ import annotations

import torch

from . import build

# rows of a chunk (csrc/columns.cu kChunk): the scratch holds one entry a
# column for each chunk but the first
CHUNK = 32


def column_pass_plain(f: torch.Tensor) -> torch.Tensor:
    """The plain version, any device: :func:`~openfdcm_tpu_torch.core.dt.
    _nearest_1d_l1` along H (two ``cummin`` calls, two flips)."""
    from ..core.dt import _nearest_1d_l1     # core.dt imports this module
    return _nearest_1d_l1(f, dim=-2)


def _check(f: torch.Tensor) -> None:
    if f.ndim < 2:
        raise ValueError(f"f: need (..., H, W), got {tuple(f.shape)}")
    build.require(f, "f", torch.float32, f.ndim)


def _launch(f: torch.Tensor, out: torch.Tensor) -> None:
    h, w = f.shape[-2:]
    planes = f.numel() // (h * w)
    suffix = torch.empty((-(-h // CHUNK) - 1) * planes * w, dtype=torch.float32,
                         device=f.device)
    build.launch("fdcm_column_pass", f.device, f.data_ptr(), out.data_ptr(),
                 suffix.data_ptr(), planes, h, w)
    column_pass.launches += 1


def column_pass(f: torch.Tensor) -> torch.Tensor:
    """The column pass of ``f (..., H, W)`` as a new tensor: the CUDA kernel
    for a CUDA tensor (counted in ``column_pass.launches``), the plain
    version for a CPU tensor.  ``f`` is left as it was."""
    _check(f)
    if not build.use_kernel(f):
        return column_pass_plain(f)
    out = torch.empty_like(f)
    if f.numel():
        _launch(f, out)
    return out


def column_pass_(f: torch.Tensor) -> torch.Tensor:
    """:func:`column_pass` in place: writes the result over ``f`` and
    returns ``f`` (the CPU path copies the plain result back)."""
    _check(f)
    if not build.use_kernel(f):
        return f.copy_(column_pass_plain(f))
    if f.numel():
        _launch(f, f)
    return f


column_pass.launches = 0
