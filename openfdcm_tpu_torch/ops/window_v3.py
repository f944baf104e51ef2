"""Kernel K6: FDCM window scores, generation 3 (identity-mapped columns).

Generation 3 scores every candidate on the 128-lane window of kernel K1,
but reads each (line, endpoint) from ONE 128-column chunk of its
orientation slice, plain (``[ls, ls + 128)``) or rolled by 64 (columns
``(ls + 64 + j) mod Q``), whichever the covered window does not cross.  The
probe column of step ``m`` is taken by the identity ``trunc(e_maj + trm) +
s*m`` (``s`` the sign of the major step ``vx = +-1``); per lane the kernel
clamps the chunk index ``li = clip(-off + s*(m_pat + t0), 0, 127)``, takes
the step of the clamped column ``m_col = s*(off + li)``, and the row
``trunc(e_min + (trn + m_col*vy))`` clamped into a 32-row band at ``y0a``
(``window_kernel.py:371-407``).  Lanes beyond the covered window ``tc``
read wherever the clamps put them, as the TPU kernel does.

The identity can differ from the reference's two-rounding probe column for
rare f32 values; :func:`identity_deviance` finds those items exactly and
the whole candidate is quarantined: ``tc = 0`` and weight 0 on every line,
so the walks resolve it on the exact lockstep path (kernel K1).

Axes as in K5 (:mod:`.window_v2`): x-major candidates read ``stack[s, d,
row, col]``, y-major ones ``stack[s, d, col, row]``; lines are summed in
the item-stream order (``order``).  The JAX package's four stack copies
(``prep_dt3_banks``: plain, rolled, transposed, rolled transpose) are index
arithmetic on the one stack here.

Replaces ``openfdcm_tpu/ops/window_kernel.py::window_scores_device_v3``
(Pallas ``_kernel_v3``), through ``window_scores_v3`` and
``window_scores_ext_v3``.  CUDA source: ``csrc/window_v3.cu``.
"""
from __future__ import annotations

import torch

from . import build
from .window import K_LANES, K_POS, check_tiles, lane_steps
from .window_v2 import (TC_MAX, PATCH_H, coverage, flat_main, global_slice,
                        line_order, major_endpoints, pack_endpoints,
                        split_major)
from ..core.rasterize import to_int_trunc

Y_BUDGET3 = 11.5       # two-sided: rows <= 2*11.5 + 2 + 7 = 32
Y_BUDGET3_EXT = 23.0   # one-sided: rows <= 23 + 2 + 7 = 32
EXT_CAP = 61.0         # one-sided cover, at most
_I32_LIMIT = float(2 ** 31)
_DEVIANCE_ELEMS = 1 << 24  # elements per step chunk of identity_deviance


def _trunc_i32(x):
    """f32 -> int32 conversion as XLA does it (NaN to 0, saturating), as
    int64: exact on ``[-2^31, 2^31)``."""
    x = torch.nan_to_num(x, nan=0.0).clamp(-_I32_LIMIT, _I32_LIMIT)
    return torch.trunc(x).to(torch.int64).clamp(-2 ** 31, 2 ** 31 - 1)


def identity_deviance(e_maj, trm, vx, tc, t0=None, span=None):
    """Items whose reference-order probe columns ``trunc(e + (trm + m*vx))``
    differ from the identity ``trunc(e + trm) + s*m`` at a covered step
    (JAX ``_identity_deviance``, ``window_kernel.py:476-503``).

    ``e_maj``: ``(..., L, E)``; ``trm``/``vx``/``tc``: ``(...,)``; ``t0``:
    optional resume steps (one-sided window ``[t0, t0 + tc]``, else the
    two-sided ``[-tc, tc]``).  Columns are compared only where ``0 <= x <
    2^30``, as in the JAX package.  Returns ``(..., L)`` bool.  Steps are
    taken in chunks so the temporaries stay small."""
    w = span if span is not None else 2 * int(TC_MAX) + 1
    lanes = torch.arange(w, dtype=torch.float32, device=e_maj.device)
    if t0 is None:
        m = (lanes - TC_MAX).expand(*tc.shape, w)
        covered = m.abs() <= tc[..., None]
    else:
        m = t0[..., None] + lanes
        covered = lanes <= tc[..., None]
    base = _trunc_i32(e_maj + trm[..., None, None])            # (..., L, E)
    s_i = torch.where(vx < 0, -1, 1).to(torch.int64)[..., None, None]
    dev = torch.zeros(e_maj.shape[:-1], dtype=torch.bool, device=e_maj.device)
    chunk = max(1, _DEVIANCE_ELEMS // max(e_maj.numel(), 1))
    for k0 in range(0, w, chunk):
        mk = m[..., k0:k0 + chunk]                             # (..., K)
        cov = covered[..., None, None, k0:k0 + chunk]
        x_true = e_maj[..., None] + (trm[..., None] + mk * vx[..., None])[..., None, None, :]
        ident = base[..., None] + s_i[..., None] * _trunc_i32(mk)[..., None, None, :]
        d = cov & (x_true >= 0.0) & (x_true < 2.0 ** 30) & (_trunc_i32(x_true) != ident)
        dev |= d.any(dim=-1).any(dim=-1)
    return dev


def _check_canvas(li):
    q = li.shape[-1]
    if li.shape[-2] != q or q % 128:
        raise ValueError(f"window generation 3 needs a square canvas whose "
                         f"side is a multiple of 128, got {tuple(li.shape[-2:])}")
    return q


def _fields(li, cand_lines, cand_mask, v, gate, tr, t0, sid, slice_idx, *,
            two_sided: bool):
    """Flat ``(M, ...)`` kernel inputs and the covered steps ``tc (M,)``,
    quarantine applied.  ``gate (M,)``: ``valid`` (main pass) or ``active``
    (extension pass, which also zeroes the cover)."""
    q = _check_canvas(li)
    finite, x_major, vx, vy, trm, trn = split_major(v, tr)
    e_maj, e_min = major_endpoints(cand_lines, x_major)
    masked_maj = torch.where(cand_mask[..., None], e_maj, torch.zeros_like(e_maj))
    if two_sided:
        tc = coverage(vy.abs(), Y_BUDGET3, float(TC_MAX), finite)
        # x_fit: the widest symmetric window around each endpoint's base
        # column that fits one aligned chunk, plain or 64-rolled
        c0 = to_int_trunc(e_maj + trm[:, None, None])
        u, r = c0 % 128, (c0 - 64) % 128
        x_fit = torch.maximum(torch.minimum(u, 127 - u), torch.minimum(r, 127 - r))
        x_fit = torch.where(cand_mask[..., None], x_fit, torch.full_like(x_fit, 127))
        tc = torch.minimum(tc, x_fit.amin(dim=(-1, -2)).to(torch.float32))
        dev = identity_deviance(masked_maj, trm, vx, tc)
    else:
        tc = coverage(vy.abs(), Y_BUDGET3_EXT, EXT_CAP, finite & gate)
        dev = identity_deviance(masked_maj, trm, vx, tc, t0=t0, span=62)
    dev_cand = (dev & cand_mask).any(dim=-1)
    tc = torch.where(dev_cand, torch.zeros_like(tc), tc)
    use = cand_mask & (gate & finite & ~dev_cand)[:, None]
    geo = torch.stack([vx, vy, trm, trn], dim=-1).contiguous()
    tc_i = tc.to(torch.int32)
    return (pack_endpoints(e_maj, e_min).contiguous(), sid,
            use.to(torch.float32).contiguous(), line_order(slice_idx), geo,
            t0.contiguous(), tc_i.contiguous(),
            x_major.to(torch.int32).contiguous()), tc_i


def window_scores_v3(li, scene_tr, cand_lines, cand_mask, rast, valid,
                     slice_idx, tiles=None):
    """Two-sided main pass (JAX ``window_scores_v3``): shapes and ``tiles``
    as :func:`.window_v2.window_scores_v2`; returns ``(scores (S, C, 128),
    tc (S, C) int32)``."""
    s, c = valid.shape
    args, tc = _fields(li, *flat_main(li, scene_tr, cand_lines, cand_mask,
                                      rast, valid, slice_idx), two_sided=True)
    out = window_v3(li, *args, two_sided=True, tiles=tiles)
    return out.reshape(s, c, K_LANES), tc.reshape(s, c)


def window_scores_v3_ext(li, cand_lines, cand_mask, vdir, active, slice_idx,
                         scene_of, scene_tr, t0, tiles=None):
    """One-sided extension pass (JAX ``window_scores_ext_v3``): ``(scores
    (b, 64), cover (b,) int32)``, lane ``l`` is step ``t0 + l``."""
    args, cover = _fields(
        li, cand_lines, cand_mask, vdir, active, scene_tr[scene_of], t0,
        global_slice(slice_idx, scene_of, li.shape[1]), slice_idx,
        two_sided=False)
    return window_v3(li, *args, two_sided=False, tiles=tiles), cover


def window_v3_plain(li, ep, sid, wt, order, geo, t0, tc, x_major, *,
                    two_sided: bool) -> torch.Tensor:
    """Plain PyTorch version of K6, any device: a Python loop over the
    lines in ``order``, bit-equal to the kernel."""
    count = K_LANES if two_sided else K_POS
    m_count, n_lines = wt.shape
    q = li.shape[-1]
    flat = li.reshape(-1)
    vx, vy, trm, trn = (geo[:, i:i + 1] for i in range(4))
    s_i = torch.where(vx < 0, -1, 1).to(torch.int64)
    t0_i = to_int_trunc(t0)[:, None]
    tc_i = tc.to(torch.int64)[:, None]
    m_lo = t0_i - tc_i if two_sided else t0_i
    m_hi = t0_i + tc_i
    m_pat = lane_steps(count, True, li.device).to(torch.int64)[None, :]
    xm_flag = x_major[:, None] != 0
    acc = torch.zeros((m_count, count), dtype=torch.float32, device=li.device)
    for j in range(n_lines):
        lj = order[:, j:j + 1].to(torch.int64)
        e = torch.gather(ep, 1, lj[..., None].expand(-1, -1, 4))[:, 0]
        w = torch.gather(wt, 1, lj)
        base = torch.gather(sid, 1, lj).to(torch.int64) * (q * q)

        def endpoint(i):
            em, en = e[:, i:i + 1], e[:, i + 1:i + 2]
            c0 = to_int_trunc(em + trm)                              # (M, 1)
            xa, xb = c0 + s_i * m_lo, c0 + s_i * m_hi
            x_lo = torch.minimum(xa, xb).clamp(0, q - 1)
            x_hi = torch.maximum(xa, xb).clamp(0, q - 1)
            crossing = (x_lo // 128) != (x_hi // 128)
            ls = torch.where(crossing, ((x_lo - 64) // 128) * 128,
                             (x_lo // 128) * 128).clamp(0, q - 128)
            x0a = ls + torch.where(crossing, 64, 0)
            ya = to_int_trunc(en + (trn + m_lo.to(torch.float32) * vy))
            yb = to_int_trunc(en + (trn + m_hi.to(torch.float32) * vy))
            y_lo = torch.minimum(ya, yb).clamp(0, q - 1)
            y0a = ((y_lo // 8) * 8).clamp(0, q - PATCH_H)
            off = x0a - c0
            li_ = (-off + s_i * (m_pat + t0_i)).clamp(0, 127)         # (M, K)
            m_col = s_i * (off + li_)
            ycol = to_int_trunc(en + (trn + m_col.to(torch.float32) * vy))
            row = y0a + (ycol - y0a).clamp(0, PATCH_H - 1)
            col = (x0a + li_) % q
            idx = base + torch.where(xm_flag, row * q + col, col * q + row)
            return flat[idx.clamp(0, flat.numel() - 1)]

        contrib = (endpoint(2) - endpoint(0)).abs() * w
        acc = acc + torch.where(w != 0, contrib, torch.zeros_like(contrib))
    return acc


def window_v3(li, ep, sid, wt, order, geo, t0, tc, x_major, *,
              two_sided: bool, tiles=None) -> torch.Tensor:
    """K6: ``(M, 128)`` (two-sided) or ``(M, 64)`` (one-sided) window
    scores.

    Inputs as :func:`.window_v2.window_v2` without the patch origins, plus
    ``tc``: int32 ``(M,)`` covered steps (they set each endpoint's chunk and
    row band); ``tiles``: optional tiled copy of ``li``
    (:func:`.window.tile_stack`), which the kernel then reads.  CUDA kernel
    for CUDA tensors, plain version (which reads ``li``) for CPU
    tensors."""
    _check_canvas(li)
    build.require(li, "li", torch.float32, 4)
    build.require(ep, "ep", torch.float32, 3)
    build.require(sid, "sid", torch.int32, 2)
    build.require(wt, "wt", torch.float32, 2)
    build.require(order, "order", torch.int32, 2)
    build.require(geo, "geo", torch.float32, 2)
    build.require(t0, "t0", torch.float32, 1)
    build.require(tc, "tc", torch.int32, 1)
    build.require(x_major, "x_major", torch.int32, 1)
    check_tiles(tiles, li)
    m_count, n_lines = wt.shape
    if (ep.shape != (m_count, n_lines, 4) or sid.shape != wt.shape
            or order.shape != wt.shape or geo.shape != (m_count, 4)
            or t0.shape != (m_count,) or tc.shape != (m_count,)
            or x_major.shape != (m_count,)):
        raise ValueError("window_v3: inconsistent candidate shapes")
    if not build.use_kernel(li, ep, sid, wt, order, geo, t0, tc, x_major,
                            *(() if tiles is None else (tiles,))):
        return window_v3_plain(li, ep, sid, wt, order, geo, t0, tc, x_major,
                               two_sided=two_sided)
    if ep.data_ptr() % 16 or geo.data_ptr() % 16:
        raise ValueError("window_v3: ep and geo must be 16-byte aligned "
                         "(the kernel reads them as float4)")
    count = K_LANES if two_sided else K_POS
    out = torch.empty((m_count, count), dtype=torch.float32, device=li.device)
    if m_count:
        build.launch("fdcm_window_v3", li.device, li.data_ptr(), li.numel(),
                     None if tiles is None else tiles.data_ptr(),
                     ep.data_ptr(), sid.data_ptr(), wt.data_ptr(),
                     order.data_ptr(), geo.data_ptr(), t0.data_ptr(),
                     tc.data_ptr(), x_major.data_ptr(), out.data_ptr(),
                     m_count, n_lines, int(two_sided), li.shape[-1])
        window_v3.launches += 1
    return out


window_v3.launches = 0
