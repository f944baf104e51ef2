"""Search strategies: which (template line, scene line) pairs to try
(port of :mod:`openfdcm_tpu.matching.search`).

The host pair tables (:func:`bank_pairs`, :func:`establish_search_strategy`)
and the bank-static and scene-length tables are host numpy, copied as they
are so their f32 values (and therefore length ties) are bit-identical to
the JAX package.  One template's pairs (:func:`_pair_by_length`) come from
the native runtime (:mod:`openfdcm_tpu_torch.native`), as in the JAX
package; :func:`_pair_by_length_plain` is its plain version.  On the
top-k path the scene-dependent windows are computed on the device with
index gathers (:func:`device_pairs`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import native
from ..core import geometry as geo

_F32_EPS = np.float32(1.1920929e-07)


@dataclasses.dataclass(frozen=True)
class DefaultSearch:
    """Each of the N longest template lines is paired with a window of the
    M closest-in-length scene lines (``defaultsearch.cpp:29-49``)."""
    max_tmpl_lines: int
    max_scene_lines: int

    def get_max_tmpl_lines(self): return self.max_tmpl_lines
    def get_max_scene_lines(self): return self.max_scene_lines


@dataclasses.dataclass(frozen=True)
class ConcentricRangeStrategy:
    """DefaultSearch restricted to scene lines whose centers fall in a
    radius annulus around ``center_position``, in the scene's own
    coordinates (``concentricrange.cpp:29-60``)."""
    max_tmpl_lines: int
    max_scene_lines: int
    center_position: tuple
    low_boundary: float
    high_boundary: float

    def get_max_tmpl_lines(self): return self.max_tmpl_lines
    def get_max_scene_lines(self): return self.max_scene_lines
    def get_center_position(self): return self.center_position
    def get_low_radius_boundary(self): return self.low_boundary
    def get_high_radius_boundary(self): return self.high_boundary


def get_centered_range(center_idx: int, vec_size: int, max_length: int):
    """Reference ``defaultsearch.h:40-47``."""
    begin = max(0, int(center_idx) - int(max_length // 2))
    end = min(begin + max_length, vec_size)
    begin = max(0, end - max_length)
    return begin, end


def _lengths(lines: np.ndarray) -> np.ndarray:
    d = lines[:, 2:4] - lines[:, 0:2]
    return np.sqrt(d[:, 0] ** 2 + d[:, 1] ** 2).astype(np.float32)


def _in_annulus(lines: np.ndarray, center, lo, hi) -> np.ndarray:
    """Lines whose centers lie at a radius in ``(lo - eps, hi)`` of
    ``center``, all in f32 (reference ``concentricrange.h:73-84``)."""
    centers = (lines[:, 0:2] + lines[:, 2:4]) / 2
    cp = np.asarray(center, np.float32)
    radius = np.sqrt(((centers - cp) ** 2).sum(axis=1)).astype(np.float32)
    return (radius > (np.float32(lo) - _F32_EPS)) & (radius < np.float32(hi))


def _closest_desc(sorted_desc: np.ndarray, value: float) -> int:
    """binarySearch on a descending array with std::greater
    (reference ``core/math.h:137-146``): lower_bound = first elem <= value,
    then pick the closer of it and its predecessor (ties to predecessor)."""
    n = len(sorted_desc)
    i = int(np.searchsorted(-sorted_desc, -np.float32(value), side="left"))
    if i == 0:
        return 0
    if i == n:
        return n - 1
    return i if abs(value - sorted_desc[i]) < abs(value - sorted_desc[i - 1]) else i - 1


def _pair_by_length(tmpl_lengths, scene_lengths, scene_ids, max_tmpl, max_scene):
    """Shared core of both strategies, on the native runtime: ``(M, 2)``
    int64 ``(template line, scene line)`` pairs.  ``scene_ids`` maps the
    filtered scene order back to original indices."""
    pairs = native.default_search_pairs(tmpl_lengths, scene_lengths,
                                        max_tmpl, max_scene)
    if pairs.size:
        pairs[:, 1] = np.asarray(scene_ids)[pairs[:, 1]]
    return pairs


def _pair_by_length_plain(tmpl_lengths, scene_lengths, scene_ids, max_tmpl,
                          max_scene):
    """:func:`_pair_by_length` in numpy, copied from the JAX package."""
    order_t = np.argsort(-tmpl_lengths, kind="stable")
    order_s = np.argsort(-scene_lengths, kind="stable")
    sorted_scene_len = scene_lengths[order_s]
    out = []
    for t in order_t[: min(len(tmpl_lengths), max_tmpl)]:
        c = _closest_desc(sorted_scene_len, tmpl_lengths[t])
        b, e = get_centered_range(c, len(sorted_scene_len), max_scene)
        for i in range(b, e):
            out.append((int(t), int(scene_ids[order_s[i]])))
    return np.array(out, np.int64).reshape(-1, 2)


def bank_pairs(strategy, tmpl_lengths_padded: np.ndarray, counts: np.ndarray,
               scene_lines: np.ndarray) -> np.ndarray:
    """All ``(tmpl_id, tmpl_line, scene_line)`` pairs of a whole template
    bank against one scene, in reference emplace order, in one vectorized
    pass (JAX ``search.bank_pairs``).

    ``tmpl_lengths_padded``: ``(T, Lmax)`` per-template line lengths (any
    value beyond ``counts[t]`` is ignored); ``counts``: ``(T,)`` real line
    counts.  DefaultSearch and ConcentricRangeStrategy only."""
    scene = geo.as_lines_np(scene_lines)
    t_count, lmax = tmpl_lengths_padded.shape
    if scene.shape[0] == 0 or t_count == 0:
        return np.zeros((0, 3), np.int32)

    if isinstance(strategy, ConcentricRangeStrategy):
        scene_ids = np.nonzero(_in_annulus(
            scene, strategy.center_position, strategy.low_boundary,
            strategy.high_boundary))[0]
    elif isinstance(strategy, DefaultSearch):
        scene_ids = np.arange(scene.shape[0])
    else:
        raise TypeError(f"unknown search strategy {strategy!r}")
    if len(scene_ids) == 0:
        return np.zeros((0, 3), np.int32)

    mt = min(strategy.max_tmpl_lines, lmax)
    ms = strategy.max_scene_lines
    if mt == 0:
        return np.zeros((0, 3), np.int32)
    scene_len = _lengths(scene[scene_ids])
    order_s = np.argsort(-scene_len, kind="stable")
    ssl = scene_len[order_s]
    n = len(ssl)
    w = min(ms, n)

    # per-template top-mt lines by length (stable desc, padding last)
    ord_t, k_t = bank_line_table(tmpl_lengths_padded, counts, mt)
    lens = np.where(np.arange(lmax)[None, :] < counts[:, None],
                    tmpl_lengths_padded, -np.inf)
    rank_ok = np.arange(mt)[None, :] < k_t[:, None]             # (T, mt)
    vals = np.take_along_axis(lens, ord_t.astype(np.int64), axis=1)

    # vectorized _closest_desc on the descending ssl
    v = vals.reshape(-1).astype(np.float32)
    i = np.searchsorted(-ssl, -v, side="left")
    ic = np.clip(i, 1, n - 1)
    closer = np.abs(v - ssl[np.clip(i, 0, n - 1)]) < np.abs(v - ssl[ic - 1])
    c = np.where(i == 0, 0,
                 np.where(i >= n, n - 1, np.where(closer, np.clip(i, 0, n - 1),
                                                  ic - 1)))
    # get_centered_range, width always min(ms, n)
    begin = np.maximum(0, c - ms // 2)
    end = np.minimum(begin + ms, n)
    begin = np.maximum(0, end - ms)                             # (T*mt,)

    sl_sorted = begin[:, None] + np.arange(w)[None, :]          # (T*mt, w)
    sl = np.asarray(scene_ids)[order_s[sl_sorted]].reshape(t_count, mt, w)
    tl = np.broadcast_to(ord_t[:, :, None], (t_count, mt, w))
    ti = np.broadcast_to(np.arange(t_count)[:, None, None], (t_count, mt, w))
    out = np.stack([ti, tl, sl], axis=-1).reshape(-1, 3)
    mask = np.broadcast_to(rank_ok[:, :, None], (t_count, mt, w)).reshape(-1)
    return np.ascontiguousarray(out[mask]).astype(np.int32)


def bank_line_table(lengths_padded: np.ndarray, counts: np.ndarray,
                    max_tmpl: int):
    """Per-template top-``max_tmpl`` line indices by length (stable desc)
    and per-template valid-rank counts: ``(ord_t (T, mt) int32, k_t (T,)
    int32)``."""
    t_count, lmax = lengths_padded.shape
    mt = min(max_tmpl, lmax)
    lens = np.where(np.arange(lmax)[None, :] < counts[:, None],
                    lengths_padded, -np.inf)
    ord_t = np.argsort(-lens, axis=1, kind="stable")[:, :mt].astype(np.int32)
    k_t = np.minimum(counts, mt).astype(np.int32)
    return ord_t, k_t


def scene_length_mask(scene_arr: np.ndarray, n_pad: int, annulus=None):
    """Host-side scene line lengths + validity for :func:`device_pairs`:
    ``(slen (n_pad,) f32, valid (n_pad,) bool)``, the lengths bit-identical
    to :func:`bank_pairs`.  ``annulus``: optional ``(cx, cy, lo, hi)``
    concentric filter in the scene's own coordinates, folded into validity
    with the reference's f32 epsilon rule."""
    n = scene_arr.shape[0]
    slen = np.zeros((n_pad,), np.float32)
    valid = np.zeros((n_pad,), bool)
    slen[:n] = _lengths(scene_arr)
    valid[:n] = True
    if annulus is not None:
        cx, cy, lo, hi = annulus
        valid[:n] &= _in_annulus(scene_arr, (cx, cy), lo, hi)
    return slen, valid


def device_pairs(slen: torch.Tensor, valid_s: torch.Tensor,
                 top_vals: torch.Tensor, rank_ok: torch.Tensor, ms: int):
    """Scene-dependent pair windows on the device, batched over scenes
    (DefaultSearch semantics, ``defaultsearch.cpp:29-49``).

    ``slen (S, N)`` f32 line lengths and ``valid_s (S, N)`` from
    :func:`scene_length_mask`; ``top_vals (T, mt)`` f32 lengths of each
    template's top lines (``-inf`` beyond ``k_t``); ``rank_ok (T, mt)``.
    Returns ``(sl (S, T, mt, ms) int64, win_ok (S, T, mt, ms) bool)`` in
    reference emplace order, including the f32 tie rules of the
    reference's ``binarySearch`` (``core/math.h:137-146``)."""
    s_count, n = slen.shape
    t_count, mt = top_vals.shape
    dev = slen.device
    pos = torch.arange(n, device=dev)
    n_eff = valid_s.sum(dim=1)[:, None]                          # (S, 1)

    # stable desc sort, filtered-out lines last (-inf keys sort to the end)
    keys = torch.where(valid_s, slen, float("-inf"))
    order_s = torch.argsort(-keys, dim=1, stable=True)
    ssl = torch.gather(keys, 1, order_s)

    v = top_vals.reshape(-1)                                     # (T*mt,)
    i = ((ssl[:, None, :] > v[None, :, None])
         & (pos < n_eff)[:, None, :]).sum(dim=2)                 # count > v
    ssl_f = torch.where(torch.isfinite(ssl), ssl, 0.0)
    at_i = torch.gather(ssl_f, 1, i.clamp(0, n - 1))
    at_p = torch.gather(ssl_f, 1, (i - 1).clamp(0, n - 1))
    closer = (v - at_i).abs() < (v - at_p).abs()
    c = torch.where(i == 0, 0, torch.where(i >= n_eff, n_eff - 1,
                                           torch.where(closer, i, i - 1)))

    begin = torch.clamp_min(c - ms // 2, 0)
    end = torch.minimum(begin + ms, n_eff)
    begin = torch.clamp_min(end - ms, 0)

    j = torch.arange(ms, device=dev)
    slot = (begin[..., None] + j) % n                            # (S, T*mt, ms)
    sl = torch.gather(order_s, 1, slot.reshape(s_count, -1))
    win_ok = ((begin[..., None] + j) < end[..., None]) \
        & rank_ok.reshape(-1)[None, :, None] & (n_eff > 0)[..., None]
    return (sl.reshape(s_count, t_count, mt, ms),
            win_ok.reshape(s_count, t_count, mt, ms))


def establish_search_strategy(strategy, tmpl_lines, scene_lines) -> np.ndarray:
    """``(M, 2)`` array of ``(tmpl_line_idx, scene_line_idx)`` for one
    template against one scene (reference ``searchstrategy.h``)."""
    tmpl = geo.as_lines_np(tmpl_lines)
    scene = geo.as_lines_np(scene_lines)
    if tmpl.shape[0] == 0 or scene.shape[0] == 0:
        return np.zeros((0, 2), np.int64)
    if isinstance(strategy, ConcentricRangeStrategy):
        ids = np.nonzero(_in_annulus(scene, strategy.center_position,
                                     strategy.low_boundary,
                                     strategy.high_boundary))[0]
        if len(ids) == 0:
            return np.zeros((0, 2), np.int64)
        return _pair_by_length(_lengths(tmpl), _lengths(scene[ids]), ids,
                               strategy.max_tmpl_lines, strategy.max_scene_lines)
    if isinstance(strategy, DefaultSearch):
        return _pair_by_length(_lengths(tmpl), _lengths(scene),
                               np.arange(scene.shape[0]),
                               strategy.max_tmpl_lines, strategy.max_scene_lines)
    raise TypeError(f"unknown search strategy {strategy!r}")


def filter_in_range(lines, center_position, min_radius, max_radius):
    """Reference ``concentricrange.h:73-84``: indices of lines whose centers
    fall in ``(min_radius - eps, max_radius)``."""
    keep = _in_annulus(geo.as_lines_np(lines), center_position, min_radius,
                       max_radius)
    return list(np.nonzero(keep)[0])
