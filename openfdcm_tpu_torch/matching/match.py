"""Match orchestration (port of :mod:`openfdcm_tpu.matching.match`).

For every template and every (template line, scene line) pair from the
search strategy, both aligning transforms are candidates (reference
``defaultmatch.cpp:62-70``); one batched optimize scores them all, then
either the device penalizes and keeps each scene's top-k, or every valid
candidate comes back in emplace order (:func:`search`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import geometry as geo
from ..core.types import resolve_device
from .optimize_kernel import optimize_candidates_batch_kernel
from .search import device_pairs


@dataclasses.dataclass
class Match:
    """Reference ``matchstrategy.h:35-45``."""
    tmpl_idx: int
    score: float
    transform: np.ndarray  # 2x3

    def __lt__(self, other):
        return self.score < other.score


@dataclasses.dataclass(frozen=True)
class DefaultMatch:
    """The (only) reference match strategy (``defaultmatch.h:31-36``)."""


def sort_matches(matches, max_num_candidates: int | None = None):
    """Sort matches ascending by score (best first); with
    ``max_num_candidates`` only the best k lead in order, the tail is
    unordered (reference ``matchstrategy.h:48-55``)."""
    if max_num_candidates is None or max_num_candidates >= len(matches):
        return sorted(matches, key=lambda m: m.score)
    k = max(int(max_num_candidates), 0)
    scores = np.asarray([m.score for m in matches], np.float64)
    part = np.argpartition(scores, k)
    head = part[:k][np.argsort(scores[part[:k]], kind="stable")]
    return [matches[i] for i in head] + [matches[i] for i in part[k:]]


def _bucket(n: int, quantum: int = 64) -> int:
    return max(quantum, -(-n // quantum) * quantum)


@dataclasses.dataclass(frozen=True)
class TemplateBank:
    """Padded template bank on a device (upload once, search many)."""
    lines: torch.Tensor    # (T, lmax, 4)
    mask: torch.Tensor     # (T, lmax)
    host: tuple            # per-template host (N_i, 4) arrays
    lengths_np: np.ndarray = None   # (T, lmax) f32 per-line lengths (padded 0)
    counts_np: np.ndarray = None    # (T,) int64 real line counts

    @property
    def lmax(self) -> int:
        return self.lines.shape[1]

    @property
    def device(self) -> torch.device:
        return self.lines.device


def prepare_templates(templates, lmax_to: int | None = None,
                      count_to: int | None = None, device="cuda") -> TemplateBank:
    """Pad templates to a common line count and put them on ``device``.

    ``lmax_to``/``count_to``: pad the line axis / template count up to
    these values (ignored when smaller); padded templates have no lines and
    never produce matches."""
    device = resolve_device(device)
    tmpls = [geo.as_lines_np(t) if np.asarray(t).size else np.zeros((0, 4), np.float32)
             for t in templates]
    if count_to is not None and count_to > len(tmpls):
        tmpls += [np.zeros((0, 4), np.float32)] * (count_to - len(tmpls))
    lmax = max(1, max((t.shape[0] for t in tmpls), default=1), lmax_to or 1)
    tbank = np.zeros((len(tmpls), lmax, 4), np.float32)
    tmask = np.zeros((len(tmpls), lmax), bool)
    for i, t in enumerate(tmpls):
        tbank[i, : t.shape[0]] = t
        tmask[i, : t.shape[0]] = True
    d = tbank[:, :, 2:4] - tbank[:, :, 0:2]
    lengths = np.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2).astype(np.float32)
    counts = tmask.sum(axis=1).astype(np.int64)
    return TemplateBank(torch.as_tensor(tbank, device=device),
                        torch.as_tensor(tmask, device=device), tuple(tmpls),
                        lengths, counts)


def _make_candidates(tmpl_lines, pair_t, pair_tl, pair_sl, scenes):
    """Aligned-template candidates for a scene batch.

    ``pair_t`` / ``pair_tl`` / ``pair_sl``: ``(S, P)`` template id,
    template line and scene line per pair (broadcast views where every
    scene shares the first two); ``scenes``: ``(S, N, 4)``.  Each pair
    yields two candidates (both polarities).  Returns ``(aligned (S, P, 2,
    lmax, 4), transforms (S, P, 2, 2, 3), align_vecs (S, P, 2))``."""
    t_line = tmpl_lines[pair_t, pair_tl]                          # (S, P, 4)
    s_line = torch.gather(scenes, 1, pair_sl[..., None].expand(-1, -1, 4))
    align_vecs = geo.normalize(s_line)                            # (S, P, 2)
    transforms = geo.align(t_line, s_line)                        # (S, P, 2, 2, 3)
    tl = tmpl_lines[pair_t]                                       # (S, P, lmax, 4)
    aligned = geo.transform(tl[:, :, None], transforms[:, :, :, None])
    return aligned, transforms, align_vecs


def _search_device_batch(tmpl_lines, tmpl_mask, pair_t, pair_tl, pair_sl,
                         scenes, li, angles, scene_tr, feature_size, *,
                         mode, window, dense_steps=0, cand_ok=None):
    """Scene-batched search: candidate generation, the batched optimize
    (walk or dense ``mode`` on the window kernels) and the transform
    combine.  Pair tables are ``(S, P)``.  Returns ``(scores (S, 2P), mats
    (S, 2P, 2, 3), valid (S, 2P))`` in reference emplace order
    (pair-major, polarity-minor)."""
    s_count, p = pair_sl.shape
    lmax = tmpl_lines.shape[1]
    aligned, transforms, align_vecs = _make_candidates(
        tmpl_lines, pair_t, pair_tl, pair_sl, scenes)
    cand_lines = aligned.reshape(s_count, 2 * p, lmax, 4)
    cand_mask = tmpl_mask[pair_t].repeat_interleave(2, dim=1)
    cand_align = align_vecs.repeat_interleave(2, dim=1)
    scores, translations, valid = optimize_candidates_batch_kernel(
        li, angles, scene_tr, feature_size, cand_lines, cand_mask, cand_align,
        mode=mode, window=window, dense_steps=dense_steps, cand_ok=cand_ok)
    # combine(translation, transform): translation applied after
    # (defaultmatch.cpp:83-84)
    mats = transforms.reshape(s_count, 2 * p, 2, 3).clone()
    mats[..., 2] += translations
    return scores, mats, valid


def _penalized_topk(scores, mats, valid, ok, tof, lengths, tau, k):
    """Penalize by ``score / max(len, 1e-6)^tau`` (``tau`` NaN: no penalty;
    reference ``exponentialpenalty.cpp:39-45``, the power through
    :func:`~openfdcm_tpu_torch.core.geometry.pow_f32`) and keep each
    scene's ``k`` best of the candidates that are ``valid & ok``, ranked
    with a stable sort so ties go to the lowest candidate index, as
    ``lax.top_k`` breaks them.  Returns ``(scores_k, mats_k, idx_k,
    valid_k)``."""
    pscores = scores if np.isnan(tau) else \
        scores / geo.pow_f32(torch.clamp_min(lengths[tof], 1e-6), tau)
    masked = torch.where(valid & ok, pscores, float("inf"))
    idx = torch.sort(masked, dim=1, stable=True).indices[:, :k]
    rows = torch.arange(scores.shape[0], device=scores.device)[:, None]
    return (torch.gather(masked, 1, idx), mats[rows, idx], idx,
            torch.gather(valid, 1, idx))


def _search_device_batch_topk(tmpl_lines, tmpl_mask, pair_t, pair_tl,
                              pair_sl, scenes, li, angles, scene_tr,
                              feature_size, lengths, tau, pair_valid, *,
                              mode, window, dense_steps, k):
    """Batched search on host pair tables ``(S, P)`` + device-side penalize
    + per-scene top-k (JAX ``match._search_device_batch_topk``).
    ``pair_valid (S, P)`` masks each scene's padding pairs; they are kept
    out of the windows and walks.  Returns ``(scores_k (S, k), mats_k (S,
    k, 2, 3), cand_idx_k (S, k), valid_k (S, k))``."""
    ok = pair_valid.repeat_interleave(2, dim=1)
    scores, mats, valid = _search_device_batch(
        tmpl_lines, tmpl_mask, pair_t, pair_tl, pair_sl, scenes, li, angles,
        scene_tr, feature_size, mode=mode, window=window,
        dense_steps=dense_steps, cand_ok=ok)
    return _penalized_topk(scores, mats, valid, ok,
                           pair_t.repeat_interleave(2, dim=1), lengths, tau, k)


def _search_device_batch_topk_genpairs(tmpl_lines, tmpl_mask, top_vals, ord_t,
                                       rank_ok, scenes, slen, svalid, li,
                                       angles, scene_tr, feature_size,
                                       lengths, tau, *, mode, window,
                                       dense_steps, k, ms):
    """Top-k search with pair generation on the device.

    Pairs come from :func:`~.search.device_pairs` on the ``(T, mt, ms)``
    grid (invalid windows folded into candidate validity), then
    :func:`_penalized_topk`.  Returns ``(scores_k, mats_k (S, k, 2, 3),
    tmpl_k, valid_k)``."""
    t_count, mt = ord_t.shape
    s_count = scenes.shape[0]
    dev = scenes.device
    sl, wok = device_pairs(slen, svalid, top_vals, rank_ok, ms)
    sl = sl.reshape(s_count, -1)
    wok = wok.reshape(s_count, -1)
    pair_t = torch.arange(t_count, device=dev).repeat_interleave(mt * ms)
    pair_tl = ord_t.reshape(-1).to(torch.int64).repeat_interleave(ms)

    cand_ok = wok.repeat_interleave(2, dim=1)
    scores, mats, valid = _search_device_batch(
        tmpl_lines, tmpl_mask, pair_t.expand(s_count, -1),
        pair_tl.expand(s_count, -1), sl, scenes, li, angles, scene_tr,
        feature_size, mode=mode, window=window, dense_steps=dense_steps,
        cand_ok=cand_ok)
    tof = pair_t.repeat_interleave(2)
    sk, mk, idx, vk = _penalized_topk(scores, mats, valid, cand_ok,
                                      tof[None].expand(s_count, -1), lengths,
                                      tau, k)
    return sk, mk, tof[idx], vk


def search(matcher, searcher, optimizer, featuremap, templates, scene) -> list:
    """Find matches of ``templates`` in ``scene`` on ``featuremap``'s device
    (reference ``defaultmatch.cpp:32-89``).  Returns an UNSORTED list of
    :class:`Match` in reference emplace order (pair-major,
    polarity-minor), scored on the window kernel of the current generation.

    ``templates``: host line arrays, or a :class:`TemplateBank` on the
    feature map's device."""
    del matcher                     # single strategy, kept for API parity
    from .pipeline import Dt3FeaturemapBatch, _search_batch_arrays
    dev = featuremap.dt3.device
    bank = templates if isinstance(templates, TemplateBank) \
        else prepare_templates(templates, device=dev)
    if bank.device != dev:
        raise ValueError(f"template bank on {bank.device}, feature map on {dev}")
    scene_arr = geo.as_lines_np(scene) if np.asarray(scene).size \
        else np.zeros((0, 4), np.float32)
    if not bank.host or scene_arr.shape[0] == 0 \
            or featuremap.feature_size == (0, 0):
        return []
    one = Dt3FeaturemapBatch(
        dt3=featuremap.dt3[None], angles=featuremap.angles,
        scene_translations=featuremap.scene_translation[None],
        feature_sizes=(tuple(featuremap.feature_size),),
        params=featuremap.params)
    (pairs, scores, mats, valid), = _search_batch_arrays(
        searcher, optimizer, one, bank, [scene_arr])
    return [Match(int(pairs[j // 2, 0]), float(scores[j]), mats[j].copy())
            for j in range(2 * pairs.shape[0]) if valid[j]]
