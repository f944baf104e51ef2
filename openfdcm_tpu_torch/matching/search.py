"""Search strategies: which (template line, scene line) pairs to try
(port of :mod:`openfdcm_tpu.matching.search`).

The bank-static and scene-length tables are host numpy, copied as they
are so their f32 values (and therefore length ties) are bit-identical to
the JAX package; the scene-dependent windows are computed on the device
with index gathers (:func:`device_pairs`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DefaultSearch:
    """Each of the N longest template lines is paired with a window of the
    M closest-in-length scene lines (``defaultsearch.cpp:29-49``)."""
    max_tmpl_lines: int
    max_scene_lines: int

    def get_max_tmpl_lines(self): return self.max_tmpl_lines
    def get_max_scene_lines(self): return self.max_scene_lines


def _lengths(lines: np.ndarray) -> np.ndarray:
    d = lines[:, 2:4] - lines[:, 0:2]
    return np.sqrt(d[:, 0] ** 2 + d[:, 1] ** 2).astype(np.float32)


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


def scene_length_mask(scene_arr: np.ndarray, n_pad: int):
    """Host-side scene line lengths + validity for :func:`device_pairs`:
    ``(slen (n_pad,) f32, valid (n_pad,) bool)``, the lengths bit-identical
    to the JAX package's host pair generation."""
    n = scene_arr.shape[0]
    slen = np.zeros((n_pad,), np.float32)
    valid = np.zeros((n_pad,), bool)
    slen[:n] = _lengths(scene_arr)
    valid[:n] = True
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
