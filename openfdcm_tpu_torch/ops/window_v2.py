"""Kernel K5: FDCM window scores, generation 2 (patch-clamped probes).

Generation 2 scores every candidate on the 128-lane window of kernel K1
(``lane(k) = k`` for ``k < 64``, ``-(k - 63)`` above, ``m = t0 + lane``),
but each probe is clamped into a 32-row x 256-column patch of its
orientation slice, one patch per (candidate, line, endpoint).  The patch
holds every probe of the candidate's covered window ``tc``; lanes beyond
``tc`` read wherever the clamp puts them, as the TPU kernel does.

Candidates are major/minor-swapped: for an x-major candidate (``|vx| >=
|vy|`` of its step vector) the major axis is x and probes read
``stack[s, d, minor, major]``; for a y-major one the axes swap and probes
read ``stack[s, d, major, minor]`` (the TPU kernel's transposed slice).
Per lane the probe is ``(trunc(e_maj + (trm + m*vx)), trunc(e_min + (trn +
m*vy)))``, every product and sum rounded to f32, then clamped to
``[x0a, x0a + 255] x [y0a, y0a + 31]``.  A candidate's lines are summed in
the TPU kernel's item-stream order: by orientation slice, then by line
index (``order``).

Replaces ``openfdcm_tpu/ops/window_kernel.py::window_scores_device`` (Pallas
``_kernel``), through its entries ``window_scores`` (two-sided main pass)
and ``window_scores_ext`` (one-sided extension pass).  CUDA source:
``csrc/window_v2.cu``.  The item stream, its sort, padding and sentinels,
and the ``cap`` of the JAX package are not carried over.
"""
from __future__ import annotations

import torch

from . import build
from .window import K_LANES, K_POS, check_tiles, lane_steps
from ..core.rasterize import to_int_trunc

PATCH_W = 256          # patch columns (major axis)
PATCH_H = 32           # patch rows (minor axis): 4 chunks of 8
TC_MAX = 62            # covered steps per direction, at most


def split_major(v, tr):
    """Per-candidate major/minor split of step vectors ``v (..., 2)`` and
    scene translations ``tr (..., 2)``: ``(finite, x_major, vx, vy, trm,
    trn)`` with ``vx``/``trm`` along the major axis."""
    rx, ry = v[..., 0], v[..., 1]
    finite = torch.isfinite(rx) & torch.isfinite(ry)
    x_major = rx.abs() >= ry.abs()
    vx = torch.where(x_major, rx, ry)
    vy = torch.where(x_major, ry, rx)
    trm = torch.where(x_major, tr[..., 0], tr[..., 1])
    trn = torch.where(x_major, tr[..., 1], tr[..., 0])
    return finite, x_major, vx, vy, trm, trn


def major_endpoints(cand_lines, x_major):
    """``(e_maj, e_min)``, each ``(..., L, 2)`` (endpoint p1, p2), of lines
    ``(..., L, 4)``."""
    ep = cand_lines.reshape(*cand_lines.shape[:-1], 2, 2)
    e_x, e_y = ep[..., 0], ep[..., 1]
    xm = x_major[..., None, None]
    return torch.where(xm, e_x, e_y), torch.where(xm, e_y, e_x)


def pack_endpoints(e_maj, e_min):
    """``(..., L, 4)`` as ``[e_maj p1, e_min p1, e_maj p2, e_min p2]``."""
    return torch.stack([e_maj[..., 0], e_min[..., 0], e_maj[..., 1],
                        e_min[..., 1]], dim=-1)


def coverage(avy, budget: float, cap: float, ok):
    """Covered steps ``min(cap, floor(budget / max(|vy|, 1e-6)))`` where
    ``ok``, else 0 (f32)."""
    tc = torch.clamp_max(torch.floor(budget / torch.clamp_min(avy, 1e-6)), cap)
    return torch.where(ok, tc, torch.zeros_like(tc))


def line_order(slice_idx):
    """Per-candidate summation order ``(M, L)`` int32: by orientation slice,
    then by line index (the TPU kernels' stable item sort)."""
    return torch.argsort(slice_idx, dim=-1, stable=True).to(torch.int32).contiguous()


def global_slice(slice_idx, scene_of, depth: int):
    """``scene * depth + slice`` int32 ``(M, L)``."""
    return (slice_idx + (scene_of * depth)[:, None]).to(torch.int32).contiguous()


def _origins(ep, vx, vy, trm, trn, m_lo, m_hi, q: int):
    """Patch origins ``(M, L, 4)`` int32 ``[x0a p1, y0a p1, x0a p2, y0a p2]``
    from the covered window's end steps ``m_lo``, ``m_hi`` with a 1-unit
    margin (``window_kernel.py:745-761``, ``:844-861``)."""
    tx_lo, tx_hi = trm + m_lo * vx, trm + m_hi * vx
    ty_lo, ty_hi = trn + m_lo * vy, trn + m_hi * vy
    out = []
    for i in (0, 2):
        ex, ey = ep[..., i], ep[..., i + 1]
        xa = to_int_trunc(ex + tx_lo[:, None])
        xb = to_int_trunc(ex + tx_hi[:, None])
        ya = to_int_trunc(ey + ty_lo[:, None])
        yb = to_int_trunc(ey + ty_hi[:, None])
        xm = torch.minimum(xa, xb) - 1
        ym = torch.minimum(ya, yb) - 1
        out.append(((xm // 128) * 128).clamp(0, q - PATCH_W))
        out.append(((ym // 8) * 8).clamp(0, q - PATCH_H))
    return torch.stack(out, dim=-1).to(torch.int32).contiguous()


def flat_main(li, scene_tr, cand_lines, cand_mask, rast, valid, slice_idx):
    """The main pass's ``(S, C, ...)`` inputs as the flat ``(M, ...)``
    positional arguments of ``_fields`` after ``li`` (``t0 = 0``)."""
    s, c, l = cand_mask.shape
    m = s * c
    scene_of = torch.arange(s, device=li.device).repeat_interleave(c)
    si = slice_idx.reshape(m, l)
    return (cand_lines.reshape(m, l, 4), cand_mask.reshape(m, l),
            rast.reshape(m, 2), valid.reshape(m), scene_tr[scene_of],
            torch.zeros(m, dtype=torch.float32, device=li.device),
            global_slice(si, scene_of, li.shape[1]), si)


def _check_canvas(li):
    q = li.shape[-1]
    if li.shape[-2] != q or q < PATCH_W:
        raise ValueError(f"window generation 2 needs a square canvas of at "
                         f"least {PATCH_W}, got {tuple(li.shape[-2:])}")
    return q


def _fields(li, cand_lines, cand_mask, v, gate, tr, t0, sid, slice_idx, *,
            budget: float, two_sided: bool):
    """Flat ``(M, ...)`` kernel inputs and the covered steps ``tc (M,)``.
    ``gate (M,)``: candidates that score (``valid`` in the main pass,
    ``active`` in the extension pass, which also zeroes their cover)."""
    q = _check_canvas(li)
    finite, x_major, vx, vy, trm, trn = split_major(v, tr)
    tc = coverage(vy.abs(), budget, float(TC_MAX),
                  finite if two_sided else finite & gate)
    e_maj, e_min = major_endpoints(cand_lines, x_major)
    ep = pack_endpoints(e_maj, e_min).contiguous()
    m_lo = t0 - tc if two_sided else t0
    org = _origins(ep, vx, vy, trm, trn, m_lo, t0 + tc, q)
    wt = (cand_mask & (gate & finite)[:, None]).to(torch.float32).contiguous()
    geo = torch.stack([vx, vy, trm, trn], dim=-1).contiguous()
    return (ep, org, sid, wt, line_order(slice_idx), geo, t0.contiguous(),
            x_major.to(torch.int32).contiguous()), tc


def window_scores_v2(li, scene_tr, cand_lines, cand_mask, rast, valid,
                     slice_idx, tiles=None):
    """Two-sided main pass (JAX ``window_scores``): ``li (S, D, Q, Q)``,
    ``scene_tr (S, 2)``, ``cand_lines (S, C, L, 4)``, ``cand_mask (S, C, L)``,
    ``rast (S, C, 2)``, ``valid (S, C)``, ``slice_idx (S, C, L)``, optional
    ``tiles`` (the tiled copy of ``li`` that the kernel reads) ->
    ``(scores (S, C, 128), tc (S, C) int32)``."""
    s, c = valid.shape
    args, tc = _fields(li, *flat_main(li, scene_tr, cand_lines, cand_mask,
                                      rast, valid, slice_idx),
                       budget=(PATCH_H - 12) / 2.0, two_sided=True)
    out = window_v2(li, *args, two_sided=True, tiles=tiles)
    return out.reshape(s, c, K_LANES), tc.to(torch.int32).reshape(s, c)


def window_scores_v2_ext(li, cand_lines, cand_mask, vdir, active, slice_idx,
                         scene_of, scene_tr, t0, tiles=None):
    """One-sided extension pass (JAX ``window_scores_ext``) on ``b``
    candidates of any scenes: lane ``l`` is step ``t0 + l`` along ``vdir``.
    Returns ``(scores (b, 64), cover (b,) int32)``: steps ``t0 .. t0 +
    cover`` are covered."""
    args, cover = _fields(
        li, cand_lines, cand_mask, vdir, active, scene_tr[scene_of], t0,
        global_slice(slice_idx, scene_of, li.shape[1]), slice_idx,
        budget=float(PATCH_H - 12), two_sided=False)
    return (window_v2(li, *args, two_sided=False, tiles=tiles),
            cover.to(torch.int32))


def window_v2_plain(li, ep, org, sid, wt, order, geo, t0, x_major, *,
                    two_sided: bool) -> torch.Tensor:
    """Plain PyTorch version of K5, any device: a Python loop over the
    lines in ``order``, bit-equal to the kernel."""
    count = K_LANES if two_sided else K_POS
    m_count, n_lines = wt.shape
    q = li.shape[-1]
    flat = li.reshape(-1)
    mult = t0[:, None] + lane_steps(count, True, li.device)[None, :]
    trx = geo[:, 2:3] + mult * geo[:, 0:1]                   # (M, K)
    try_ = geo[:, 3:4] + mult * geo[:, 1:2]
    xm = x_major[:, None] != 0
    acc = torch.zeros((m_count, count), dtype=torch.float32, device=li.device)
    for j in range(n_lines):
        lj = order[:, j:j + 1].to(torch.int64)
        e = torch.gather(ep, 1, lj[..., None].expand(-1, -1, 4))[:, 0]
        o = torch.gather(org, 1, lj[..., None].expand(-1, -1, 4))[:, 0].to(torch.int64)
        w = torch.gather(wt, 1, lj)
        base = torch.gather(sid, 1, lj).to(torch.int64) * (q * q)

        def probe(i):
            xi = to_int_trunc(e[:, i:i + 1] + trx)
            yi = to_int_trunc(e[:, i + 1:i + 2] + try_)
            maj = o[:, i:i + 1] + (xi - o[:, i:i + 1]).clamp(0, PATCH_W - 1)
            mnr = o[:, i + 1:i + 2] + (yi - o[:, i + 1:i + 2]).clamp(0, PATCH_H - 1)
            idx = base + torch.where(xm, mnr * q + maj, maj * q + mnr)
            return flat[idx.clamp(0, flat.numel() - 1)]

        contrib = (probe(2) - probe(0)).abs() * w
        acc = acc + torch.where(w != 0, contrib, torch.zeros_like(contrib))
    return acc


def window_v2(li, ep, org, sid, wt, order, geo, t0, x_major, *,
              two_sided: bool, tiles=None) -> torch.Tensor:
    """K5: ``(M, 128)`` (two-sided) or ``(M, 64)`` (one-sided) window
    scores.

    ``li``: float32 stack ``(S, D, Q, Q)``; ``ep``: ``(M, L, 4)`` endpoints
    ``[maj, min, maj, min]``; ``org``: int32 ``(M, L, 4)`` patch origins
    ``[x0a, y0a, x0a, y0a]``; ``sid``: int32 ``(M, L)`` global slice;
    ``wt``: ``(M, L)`` weights; ``order``: int32 ``(M, L)`` summation order;
    ``geo``: ``(M, 4)`` ``[vx, vy, trm, trn]``; ``t0``: ``(M,)`` first step;
    ``x_major``: int32 ``(M,)``; ``tiles``: optional tiled copy of ``li``
    (:func:`.window.tile_stack`), which the kernel then reads.  CUDA kernel
    for CUDA tensors, plain version (which reads ``li``) for CPU
    tensors."""
    _check_canvas(li)
    build.require(li, "li", torch.float32, 4)
    build.require(ep, "ep", torch.float32, 3)
    build.require(org, "org", torch.int32, 3)
    build.require(sid, "sid", torch.int32, 2)
    build.require(wt, "wt", torch.float32, 2)
    build.require(order, "order", torch.int32, 2)
    build.require(geo, "geo", torch.float32, 2)
    build.require(t0, "t0", torch.float32, 1)
    build.require(x_major, "x_major", torch.int32, 1)
    check_tiles(tiles, li)
    m_count, n_lines = wt.shape
    if (ep.shape != (m_count, n_lines, 4) or org.shape != (m_count, n_lines, 4)
            or sid.shape != wt.shape or order.shape != wt.shape
            or geo.shape != (m_count, 4) or t0.shape != (m_count,)
            or x_major.shape != (m_count,)):
        raise ValueError("window_v2: inconsistent candidate shapes")
    if not build.use_kernel(li, ep, org, sid, wt, order, geo, t0, x_major,
                            *(() if tiles is None else (tiles,))):
        return window_v2_plain(li, ep, org, sid, wt, order, geo, t0, x_major,
                               two_sided=two_sided)
    if ep.data_ptr() % 16 or org.data_ptr() % 16 or geo.data_ptr() % 16:
        raise ValueError("window_v2: ep, org and geo must be 16-byte aligned "
                         "(the kernel reads them as int4/float4)")
    count = K_LANES if two_sided else K_POS
    out = torch.empty((m_count, count), dtype=torch.float32, device=li.device)
    if m_count:
        build.launch("fdcm_window_v2", li.device, li.data_ptr(), li.numel(),
                     None if tiles is None else tiles.data_ptr(),
                     ep.data_ptr(), org.data_ptr(), sid.data_ptr(),
                     wt.data_ptr(), order.data_ptr(), geo.data_ptr(),
                     t0.data_ptr(), x_major.data_ptr(), out.data_ptr(),
                     m_count, n_lines, count, li.shape[-1])
        window_v2.launches += 1
    return out


window_v2.launches = 0
