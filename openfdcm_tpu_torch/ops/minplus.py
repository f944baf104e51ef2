"""Kernel K2: the exact L2² / L2 row pass of the distance transform.

``out[..., y, x] = min_s (g[..., y, s]² + (x - s)²)`` over each row's
finite sources, where ``g`` holds the column-pass distances (integers in
``[0, H)``, ``F32_MAX`` for a column without a seed); then ``min(., F32_MAX)``
and, for L2, the IEEE square root of every finite value (``F32_MAX`` stays).

Replaces ``openfdcm_tpu/ops/minplus_kernel.py::minplus_rows_banded``
(Pallas ``_kernel``) and the row-direction L1 transform that gave it its
band.  CUDA source: ``csrc/minplus.cu``: an exact integer lower envelope,
O(W) per row, then :func:`far_pass` for the pixels 4096 px or more from
their nearest source, whose value is a band scan's minimum (an envelope
pass marks them in ``out`` and lists their rows).  Canvases with a side
above :data:`MAX_SIDE` run the envelope on 64-bit arithmetic
(:func:`minplus_rows_wide`).
"""
from __future__ import annotations

import torch

from . import build
from ..core.geometry import sqrt_f32
from ..core.types import F32_MAX

# The kernel's exact int32 arithmetic holds for H, W <= 16384; larger
# canvases run its 64-bit arithmetic.
MAX_SIDE = 16384
# Resident one-warp blocks an SM can hold (Hopper): the kernel's grid, and
# so its scratch, is at most this many per SM.
BLOCKS_PER_SM = 32


def minplus_rows_plain(g: torch.Tensor, *, sqrt: bool) -> torch.Tensor:
    """Plain PyTorch version, any device: the band scan over ``s in [x - l1,
    x + l1]`` (``l1`` the exact L1 distance of the same seeds, which bounds
    the winning source's offset), one shifted-min pass per offset."""
    from ..core.dt import _nearest_1d_l1   # core.dt imports this module
    w = g.shape[-1]
    rows = g.reshape(-1, w)
    g2 = rows * rows                 # F32_MAX² overflows to inf on purpose
    l1 = _nearest_1d_l1(rows)
    out = g2.clone()
    finite = l1 < F32_MAX
    radius = int(torch.clamp_max(l1[finite].max(), w - 1)) if bool(finite.any()) else 0
    for d in range(1, radius + 1):
        dd = float(d * d)
        right = out[:, d:]                       # sources left of the pixel
        torch.minimum(right, g2[:, :-d] + dd, out=right)
        left = out[:, :-d]                       # sources right of the pixel
        torch.minimum(left, g2[:, d:] + dd, out=left)
    out = torch.clamp_max(out, F32_MAX)
    if sqrt:
        out = torch.where(out >= F32_MAX, out, sqrt_f32(out))
    return out.reshape(g.shape)


def scratch_blocks(n: int, device) -> int:
    """The kernel's grid for ``n`` rows: one block per 32 rows, at most
    :data:`BLOCKS_PER_SM` an SM.  Its scratch, ``blocks * 32 * W`` entries
    (32-bit, 64-bit in :func:`minplus_rows_wide`), never exceeds the output
    rounded up to 32 rows (twice that when wide); on an H100 (132 SMs) a
    10-scene 30 x 640² build takes 4224 blocks, 346 MB of scratch beside its
    491 MB output."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return min(-(-n // 32), sms * BLOCKS_PER_SM)


def _check(g: torch.Tensor) -> None:
    if g.ndim < 2:
        raise ValueError(f"g: need (..., H, W), got {tuple(g.shape)}")
    build.require(g, "g", torch.float32, g.ndim)


def _envelope(entry: str, g: torch.Tensor, sqrt: bool, dtype):
    """``entry`` (an envelope pass) on ``g``'s rows with a scratch of
    ``dtype`` entries: ``(out, far)``, far pixels marked in ``out`` and
    their rows listed in ``far``."""
    out = torch.empty_like(g)
    w = g.shape[-1]
    n = g.numel() // w
    blocks = scratch_blocks(n, g.device)
    # each block's 32 envelope stacks of up to w entries
    scratch = torch.empty(blocks * 32 * w, dtype=dtype, device=g.device)
    far = torch.empty(far_capacity(n), dtype=torch.int64, device=g.device)
    build.launch(entry, g.device, g.data_ptr(), out.data_ptr(),
                 scratch.data_ptr(), far.data_ptr(), blocks, n, w, int(sqrt))
    return out, far


def envelope(g: torch.Tensor, *, sqrt: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """K2's envelope pass alone on a CUDA ``g`` (the 64-bit kernel when
    ``max(H, W) > MAX_SIDE``): ``(out, far)`` with every far pixel marked
    in ``out`` (:func:`far_marks`) and ``far`` as :func:`far_pass` takes
    it.  :func:`minplus_rows` runs it and then :func:`far_pass`; this is
    for measuring the two apart.  No launch counter, no plain version."""
    _check(g)
    if g.device.type != "cuda" or not g.numel():
        raise ValueError("envelope: a non-empty CUDA tensor only "
                         "(minplus_rows_plain is K2's plain version)")
    if max(g.shape[-2:]) > MAX_SIDE:
        return _envelope("fdcm_minplus_rows_wide", g, sqrt, torch.int64)
    return _envelope("fdcm_minplus_rows", g, sqrt, torch.int32)


def far_capacity(n: int) -> int:
    """Entries of the far-row list of ``n`` rows: the count, then at most
    one entry a row."""
    return n + 1


def far_marks(out: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The far pixels an envelope pass marked in ``out`` (the sign bit set,
    which no value of K2 has) and each one's band radius (the low 31
    bits), both shaped like ``out``."""
    bits = out.view(torch.int32)
    return bits < 0, bits & 0x7FFFFFFF


def far_work(out: torch.Tensor) -> tuple[int, int, int]:
    """``(pixels, candidates, rows)`` of the far pass on an envelope's
    marked ``out``: the marked pixels, the band sources they scan (the
    band ``[x - r, x + r]`` clipped to the row), the rows holding them."""
    w = out.shape[-1]
    marked, radius = far_marks(out.reshape(-1, w))
    x = torch.arange(w, device=out.device).expand_as(marked)
    r = radius.long()
    band = torch.minimum(x + r, torch.full_like(r, w - 1)) - torch.clamp_min(x - r, 0) + 1
    return (int(marked.sum()), int(band[marked].sum()),
            int(marked.any(dim=1).sum()))


def far_pass_plain(g: torch.Tensor, out: torch.Tensor, far: torch.Tensor, *,
                   sqrt: bool) -> torch.Tensor:
    """Plain PyTorch version of :func:`far_pass`, any device: a copy of
    ``out`` whose marked pixels hold :func:`minplus_rows_plain`'s values."""
    marked, _ = far_marks(out)
    return torch.where(marked, minplus_rows_plain(g, sqrt=sqrt), out)


def far_pass(g: torch.Tensor, out: torch.Tensor, far: torch.Tensor, *,
             sqrt: bool) -> torch.Tensor:
    """K2's far pass on an envelope's ``out`` and ``far``, in place:
    returns ``out`` with every marked pixel's band-scan minimum (its root
    when ``sqrt``).  The CUDA kernel for CUDA tensors (launched whether or
    not a row is listed: the count stays on the card), the plain version
    (copied back) for CPU tensors."""
    _check(g)
    if g.shape != out.shape or out.dtype != torch.float32 or not out.is_contiguous():
        raise ValueError(f"out: need a contiguous float32 {tuple(g.shape)}, "
                         f"got {tuple(out.shape)} {out.dtype}")
    w = g.shape[-1]
    n = g.numel() // w if g.numel() else 0
    if far.dtype != torch.int64 or far.ndim != 1 or far.numel() != far_capacity(n):
        raise ValueError(f"far: need {far_capacity(n)} int64 entries, got "
                         f"{tuple(far.shape)} {far.dtype}")
    if not build.use_kernel(g, out, far):
        return out.copy_(far_pass_plain(g, out, far, sqrt=sqrt))
    if not n:
        return out
    build.launch("fdcm_minplus_far", g.device, g.data_ptr(), out.data_ptr(),
                 far.data_ptr(), n, w, int(sqrt))
    far_pass.launches += 1
    return out


def minplus_rows(g: torch.Tensor, *, sqrt: bool) -> torch.Tensor:
    """K2 on float32 column-pass distances ``g (..., H, W)`` of any size
    (device memory bounds the canvas): the envelope and far-pass kernels
    for CUDA tensors (:func:`minplus_rows_wide` when ``max(H, W) >
    MAX_SIDE``), the plain version for CPU tensors.  ``sqrt``: L2 (else
    L2²)."""
    _check(g)
    if not build.use_kernel(g):
        return minplus_rows_plain(g, sqrt=sqrt)
    if max(g.shape[-2:]) > MAX_SIDE:
        return minplus_rows_wide(g, sqrt=sqrt)
    if not g.numel():
        return torch.empty_like(g)
    out, far = _envelope("fdcm_minplus_rows", g, sqrt, torch.int32)
    minplus_rows.launches += 1
    return far_pass(g, out, far, sqrt=sqrt)


def minplus_rows_wide(g: torch.Tensor, *, sqrt: bool) -> torch.Tensor:
    """K2 on 64-bit envelope arithmetic, for any ``(..., H, W)`` (the
    kernel behind :func:`minplus_rows` on canvases with a side above
    :data:`MAX_SIDE`), then :func:`far_pass`: the CUDA kernels for CUDA
    tensors, the plain version for CPU tensors."""
    _check(g)
    if not build.use_kernel(g):
        return minplus_rows_plain(g, sqrt=sqrt)
    if not g.numel():
        return torch.empty_like(g)
    out, far = _envelope("fdcm_minplus_rows_wide", g, sqrt, torch.int64)
    minplus_rows_wide.launches += 1
    return far_pass(g, out, far, sqrt=sqrt)


minplus_rows.launches = 0
minplus_rows_wide.launches = 0
far_pass.launches = 0
