"""Kernel K1: FDCM window scores.

For each candidate ``c`` and step lane ``k`` the score is

    sum over lines l, in line order, of  wt[c,l] * |LI[p1 + tr] - LI[p2 + tr]|

with ``tr = scene_tr + m * v`` and ``m = t0[c] + lane(k)``, each product and
sum rounded to f32 in the reference's op order (``dt3cpu.cpp:126-179``:
``tr`` first, then ``p = e + tr``, int-truncated).  Probes gather from the
flattened LI stack ``(S, D, H, W)`` at ``sid * H * W + y * W + x``, clamped
to the stack as ``jnp.take(..., mode="clip")`` does
(``featuremap.py:658-659``).  Lines of weight 0 are skipped.

Lane patterns: two-sided (128 lanes, the main pass: ``lane(k) = k`` for
``k < 64``, ``-(k - 63)`` above) or one-sided (``lane(k) = k``, ``count``
lanes: the straggler extension pass and the walk backstops).

The kernel reads either the row-major stack or its tiled copy
(:func:`tile_stack`: 8 x 4 tiles of 128 bytes, each 32-byte sector a 4 x 2
block), which a caller makes once per search dispatch and hands to every
call: a warp's 32 probes along a y-major ray then touch about 8 cache lines
instead of 32.  Both give the same scores.  Kernels K5 and K6
(:mod:`.window_v2`, :mod:`.window_v3`) read the same copy.

Replaces ``openfdcm_tpu/ops/window_kernel.py::window_scores_device_v4``
(Pallas ``_kernel_v4``, via ``window_scores_v4`` and
``window_scores_ext_v4``).  CUDA source: ``csrc/window.cu``.
"""
from __future__ import annotations

import torch

from . import build
from ..core.rasterize import to_int_trunc

K_LANES = 128          # two-sided main pass: 64 steps m >= 0, 64 steps m < 0
K_POS = 64             # lane k < 64 holds m = +k; lane k >= 64 holds m = -(k - 63)


def lane_steps(count: int, two_sided: bool, device) -> torch.Tensor:
    """Step offset of each lane, f32."""
    k = torch.arange(count, dtype=torch.float32, device=device)
    if two_sided:
        k = torch.where(k < K_POS, k, -(k - (K_POS - 1)))
    return k


def tile_shape(li_shape) -> tuple[int, int, int, int]:
    """Shape of the tiled copy of an ``(S, D, H, W)`` stack:
    ``(S * D, ceil(H / 4), ceil(W / 8), 32)``."""
    s, d, h, w = li_shape
    return (s * d, -(-h // 4), -(-w // 8), 32)


def tile_stack_plain(li: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`tile_stack`, any device: pad to whole
    tiles with 0, then permute.  Element ``(q, y, x)`` of the stack lands at
    ``[q, y // 4, x // 8, i]`` with ``i = 16 (y // 2 % 2) + 8 (x // 4 % 2) +
    4 (y % 2) + x % 4``."""
    n, th, tw, _ = tile_shape(li.shape)
    h, w = li.shape[-2:]
    x = torch.nn.functional.pad(li.reshape(n, h, w), (0, tw * 8 - w, 0, th * 4 - h))
    x = x.reshape(n, th, 2, 2, tw, 2, 4).permute(0, 1, 4, 2, 5, 3, 6)
    return x.reshape(n, th, tw, 32)


def tile_stack(li: torch.Tensor) -> torch.Tensor:
    """The tiled copy of a float32 LI stack ``(S, D, H, W)`` that
    :func:`window_scores` reads through ``tiles=``: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    build.require(li, "li", torch.float32, 4)
    if not build.use_kernel(li):
        return tile_stack_plain(li)
    out = torch.empty(tile_shape(li.shape), dtype=torch.float32, device=li.device)
    if li.numel():
        n, h, w = out.shape[0], li.shape[-2], li.shape[-1]
        build.launch("fdcm_window_tiles", li.device, li.data_ptr(),
                     out.data_ptr(), n, h, w)
        tile_stack.launches += 1
    return out


tile_stack.launches = 0


def check_tiles(tiles, li) -> None:
    """Raise unless ``tiles`` is None or a :func:`tile_stack` of ``li``'s
    shape (a window wrapper's ``tiles=`` argument)."""
    if tiles is None:
        return
    build.require(tiles, "tiles", torch.float32, 4)
    if tuple(tiles.shape) != tile_shape(li.shape):
        raise ValueError(f"tiles {tuple(tiles.shape)}: need "
                         f"{tile_shape(li.shape)} for li {tuple(li.shape)}")


def window_scores_plain(li, ep, sid, wt, tr, v, t0, *, count: int,
                        two_sided: bool, take=None) -> torch.Tensor:
    """Plain PyTorch version, any device: a Python loop over lines so the
    sum runs in line order, bit-equal to the kernel.

    ``take``: optional reader of the stack's values (the JAX package's
    ``take_fn`` layout): called once with every probe's unclamped flat
    index, ``(2, L, M * count)`` (endpoint, line, candidate-major lane), it
    returns their values, clamping into the stack as the default gather
    does (the row-sharded search's gather,
    :mod:`openfdcm_tpu_torch.parallel.spatial`); ``li`` then stands for the
    stack through its ``shape`` and ``device`` only."""
    m_count, n_lines = wt.shape
    q_w = li.shape[-1]
    hw = li.shape[-2] * q_w
    mult = t0[:, None] + lane_steps(count, two_sided, li.device)[None, :]
    trx = tr[:, 0:1] + mult * v[:, 0:1]                      # (M, K)
    tr_y = tr[:, 1:2] + mult * v[:, 1:2]

    def index(j, ix, iy):
        xi = to_int_trunc(ep[:, j, ix:ix + 1] + trx)
        yi = to_int_trunc(ep[:, j, iy:iy + 1] + tr_y)
        return sid[:, j:j + 1].to(torch.int64) * hw + yi * q_w + xi

    if take is None:
        flat = li.reshape(-1)
        probes = lambda j: [flat[index(j, *e).clamp(0, flat.numel() - 1)]
                            for e in ((0, 1), (2, 3))]
    elif n_lines:
        idx = torch.stack([torch.stack([index(j, 0, 1), index(j, 2, 3)])
                           for j in range(n_lines)], dim=1)   # (2, L, M, K)
        vals = take(idx.reshape(2, n_lines, -1)).reshape(idx.shape)
        probes = lambda j: vals[:, j]
    acc = torch.zeros((m_count, count), dtype=torch.float32, device=li.device)
    for j in range(n_lines):
        w = wt[:, j:j + 1]
        a, b = probes(j)
        contrib = (a - b).abs() * w
        acc = acc + torch.where(w != 0, contrib, torch.zeros_like(contrib))
    return acc


def window_scores(li, ep, sid, wt, tr, v, t0, *, count: int,
                  two_sided: bool, tiles=None) -> torch.Tensor:
    """K1: ``(M, count)`` window scores.

    ``li``: float32 LI stack ``(S, D, H, W)``; ``ep``: ``(M, L, 4)`` line
    endpoints (no scene translation); ``sid``: int32 ``(M, L)`` global slice
    ``scene * D + orientation``; ``wt``: ``(M, L)`` line weights; ``tr``:
    ``(M, 2)`` scene translations; ``v``: ``(M, 2)`` step vectors; ``t0``:
    ``(M,)`` first step; ``tiles``: optional :func:`tile_stack` of ``li``,
    which the kernel then reads instead of ``li``.  CUDA kernel for CUDA
    tensors, plain version for CPU tensors."""
    if two_sided and count != K_LANES:
        raise ValueError(f"the two-sided pattern has {K_LANES} lanes, not {count}")
    build.require(li, "li", torch.float32, 4)
    build.require(ep, "ep", torch.float32, 3)
    build.require(sid, "sid", torch.int32, 2)
    build.require(wt, "wt", torch.float32, 2)
    build.require(tr, "tr", torch.float32, 2)
    build.require(v, "v", torch.float32, 2)
    build.require(t0, "t0", torch.float32, 1)
    check_tiles(tiles, li)
    m_count, n_lines = wt.shape
    if (ep.shape != (m_count, n_lines, 4) or sid.shape != (m_count, n_lines)
            or tr.shape != (m_count, 2) or v.shape != (m_count, 2)
            or t0.shape != (m_count,)):
        raise ValueError("window_scores: inconsistent candidate shapes")
    if not build.use_kernel(li, ep, sid, wt, tr, v, t0,
                            *(() if tiles is None else (tiles,))):
        return window_scores_plain(li, ep, sid, wt, tr, v, t0, count=count,
                                   two_sided=two_sided)
    if ep.data_ptr() % 16 or tr.data_ptr() % 8 or v.data_ptr() % 8:
        raise ValueError("window_scores: ep must be 16-byte and tr, v 8-byte "
                         "aligned (the kernel reads float4/float2)")
    out = torch.empty((m_count, count), dtype=torch.float32, device=li.device)
    if m_count and count:
        h, w = li.shape[-2:]
        build.launch("fdcm_window", li.device, li.data_ptr(), li.numel(),
                     None if tiles is None else tiles.data_ptr(),
                     ep.data_ptr(), sid.data_ptr(), wt.data_ptr(),
                     tr.data_ptr(), v.data_ptr(), t0.data_ptr(),
                     out.data_ptr(), m_count, n_lines, count, int(two_sided),
                     h, w)
        window_scores.launches += 1
    return out


window_scores.launches = 0
