"""Match orchestration (port of :mod:`openfdcm_tpu.matching.match`).

For every template and every (template line, scene line) pair from the
search strategy, both aligning transforms are candidates (reference
``defaultmatch.cpp:62-70``); one batched optimize scores them all, then the
device penalizes and keeps each scene's top-k.
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

    ``pair_t``/``pair_tl``: ``(P,)`` template id and template line per pair
    (shared by all scenes); ``pair_sl``: ``(S, P)`` scene line; ``scenes``:
    ``(S, N, 4)``.  Each pair yields two candidates (both polarities).
    Returns ``(aligned (S, P, 2, lmax, 4), transforms (S, P, 2, 2, 3),
    align_vecs (S, P, 2))``."""
    t_line = tmpl_lines[pair_t, pair_tl]                          # (P, 4)
    s_line = torch.gather(scenes, 1, pair_sl[..., None].expand(-1, -1, 4))
    align_vecs = geo.normalize(s_line)                            # (S, P, 2)
    transforms = geo.align(t_line.expand_as(s_line), s_line)      # (S, P, 2, 2, 3)
    tl = tmpl_lines[pair_t]                                       # (P, lmax, 4)
    aligned = geo.transform(tl[None, :, None], transforms[:, :, :, None])
    return aligned, transforms, align_vecs


def _search_device_batch(tmpl_lines, tmpl_mask, pair_t, pair_tl, pair_sl,
                         scenes, li, angles, scene_tr, feature_size, *,
                         mode, window, cand_ok=None):
    """Scene-batched search: candidate generation, the batched optimize
    (walk ``mode`` on the window kernels) and the transform combine.  Returns ``(scores (S, 2P), mats
    (S, 2P, 2, 3), valid (S, 2P))`` in reference emplace order
    (pair-major, polarity-minor)."""
    s_count, p = pair_sl.shape
    lmax = tmpl_lines.shape[1]
    aligned, transforms, align_vecs = _make_candidates(
        tmpl_lines, pair_t, pair_tl, pair_sl, scenes)
    cand_lines = aligned.reshape(s_count, 2 * p, lmax, 4)
    cand_mask = tmpl_mask[pair_t].repeat_interleave(2, dim=0)[None].expand(
        s_count, -1, -1)
    cand_align = align_vecs.repeat_interleave(2, dim=1)
    scores, translations, valid = optimize_candidates_batch_kernel(
        li, angles, scene_tr, feature_size, cand_lines, cand_mask, cand_align,
        mode=mode, window=window, cand_ok=cand_ok)
    # combine(translation, transform): translation applied after
    # (defaultmatch.cpp:83-84)
    mats = transforms.reshape(s_count, 2 * p, 2, 3).clone()
    mats[..., 2] += translations
    return scores, mats, valid


def _search_device_batch_topk_genpairs(tmpl_lines, tmpl_mask, top_vals, ord_t,
                                       rank_ok, scenes, slen, svalid, li,
                                       angles, scene_tr, feature_size,
                                       lengths, tau, *, mode, window, k, ms):
    """Top-k search with pair generation on the device.

    Pairs come from :func:`~.search.device_pairs` on the ``(T, mt, ms)``
    grid (invalid windows folded into candidate validity); scores are
    penalized by ``score / max(len, 1e-6)^tau`` (``tau`` NaN: no penalty;
    reference ``exponentialpenalty.cpp:39-45``) and ranked with a stable
    sort, so ties go to the lowest candidate index as ``lax.top_k`` breaks
    them.  Returns ``(scores_k, mats_k (S, k, 2, 3), tmpl_k, valid_k)``."""
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
        tmpl_lines, tmpl_mask, pair_t, pair_tl, sl, scenes, li, angles,
        scene_tr, feature_size, mode=mode, window=window, cand_ok=cand_ok)
    tof = pair_t.repeat_interleave(2)
    pscores = scores if np.isnan(tau) else \
        scores / torch.pow(torch.clamp_min(lengths[tof], 1e-6), tau)
    masked = torch.where(valid & cand_ok, pscores, float("inf"))
    idx = torch.sort(masked, dim=1, stable=True).indices[:, :k]
    return (torch.gather(masked, 1, idx),
            mats[torch.arange(s_count, device=dev)[:, None], idx],
            tof[idx], torch.gather(valid, 1, idx))
