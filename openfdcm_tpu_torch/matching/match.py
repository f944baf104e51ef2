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


def _gather(parts, device, dim=1):
    """Per-shard tensors concatenated along ``dim`` in shard order on
    ``device`` (the mesh's all-gather)."""
    return torch.cat([t.to(device) for t in parts], dim=dim)


def _gather_rerank(device, k, vals, gidx, *extras):
    """The cross-shard merge of the cand- and bank-sharded top-k paths (JAX
    ``match._gather_rerank``): per-shard ``(S, kk)`` scores ``vals`` and
    global candidate indices ``gidx`` (lists, one entry per shard) gathered
    onto ``device`` and ranked by (score, global index); ``extras``: lists
    of per-shard ``(S, kk, ...)`` tensors reordered the same way.  Returns
    ``(vals_k, gidx_k, *extras_k)`` of width ``k``."""
    fv, fi = _gather(vals, device), _gather(gidx, device)
    by_idx = torch.sort(fi, dim=1, stable=True).indices
    by_val = torch.sort(torch.gather(fv, 1, by_idx), dim=1, stable=True).indices
    order = torch.gather(by_idx, 1, by_val)[:, :k]

    def take(parts):
        flat = _gather(parts, device)
        idx = order.reshape(order.shape + (1,) * (flat.ndim - 2))
        return torch.gather(flat, 1, idx.expand(order.shape + flat.shape[2:]))
    return (torch.gather(fv, 1, order), torch.gather(fi, 1, order),
            *[take(e) for e in extras])


def _scene_blocks(mesh, axis, s_count):
    """``(device of block i's first entry, rows of block i)`` for the
    ``mesh[axis]`` blocks of a scene batch of ``s_count`` (a multiple of the
    axis size)."""
    n = mesh.axis_size(axis)
    if s_count % n:
        raise ValueError(f"{s_count} scenes do not split into {n} equal blocks")
    b = s_count // n
    return [(mesh.device(**{axis: i}), slice(i * b, (i + 1) * b)) for i in range(n)]


def _on(device, *tensors):
    return tuple(t.to(device) for t in tensors)


def _replicas(mesh, device, *tensors):
    """The bank's tables on ``device``, copied once per distinct device
    (:meth:`~openfdcm_tpu_torch.parallel.Mesh.replica`)."""
    return tuple(mesh.replica(t, device) for t in tensors)


def _search_device_batch_topk_sharded(mesh, tmpl_lines, tmpl_mask, pair_t,
                                      pair_tl, pair_sl, scenes, li, angles,
                                      scene_tr, feature_size, lengths, tau,
                                      pair_valid, *, mode, window, dense_steps,
                                      k, scene_axis="scene", cand_axis="cand"):
    """:func:`_search_device_batch_topk` on a mesh (JAX
    ``match._search_device_batch_topk_sharded``): scene blocks along
    ``scene_axis``, each block's pairs in blocks along ``cand_axis``; every
    shard searches, penalizes and keeps its ``min(k, 2P / n_cand)`` best on
    its device, and where candidates span shards the shards' rows are
    gathered and re-ranked by (score, global candidate index).  Results
    are gathered onto ``li``'s device."""
    out_dev = li.device
    n_cand = mesh.axis_size(cand_axis)
    p = pair_t.shape[1]
    if p % n_cand:
        raise ValueError(f"{p} pairs do not split into {n_cand} equal blocks")
    p_blk = p // n_cand
    c_local = 2 * p_blk
    kk = min(k, c_local)
    rows_out = []
    for i, (_, rows) in enumerate(_scene_blocks(mesh, scene_axis, li.shape[0])):
        shards = []
        for j in range(n_cand):
            dev = mesh.device(**{scene_axis: i, cand_axis: j})
            cols = slice(j * p_blk, (j + 1) * p_blk)
            pt, ptl, psl, pv = _on(dev, pair_t[rows, cols], pair_tl[rows, cols],
                                   pair_sl[rows, cols], pair_valid[rows, cols])
            ok = pv.repeat_interleave(2, dim=1)
            scores, mats, valid = _search_device_batch(
                *_replicas(mesh, dev, tmpl_lines, tmpl_mask), pt, ptl, psl,
                *_on(dev, scenes[rows], li[rows], angles, scene_tr[rows],
                     feature_size[rows]),
                mode=mode, window=window, dense_steps=dense_steps, cand_ok=ok)
            sk, mk, idx, vk = _penalized_topk(
                scores, mats, valid, ok, pt.repeat_interleave(2, dim=1),
                mesh.replica(lengths, dev), tau, kk)
            shards.append((sk, mk, idx + j * c_local, vk))
        sk, mk, ik, vk = zip(*shards)
        if n_cand > 1:
            sk, ik, mk, vk = _gather_rerank(out_dev, min(k, n_cand * kk), sk, ik,
                                            mk, vk)
            rows_out.append((sk, mk, ik, vk))
        else:
            rows_out.append((sk[0], mk[0], ik[0], vk[0]))
    return tuple(_gather(parts, out_dev, dim=0) for parts in zip(*rows_out))


def _search_device_batch_sharded(mesh, tmpl_lines, tmpl_mask, pair_t, pair_tl,
                                 pair_sl, scenes, li, angles, scene_tr,
                                 feature_size, *, mode, window, dense_steps,
                                 axis="scene", cand_ok=None):
    """Scene-data-parallel :func:`_search_device_batch` (JAX
    ``match._search_device_batch_sharded``): each ``mesh[axis]`` block of
    scenes is searched on its device, with no traffic between shards;
    results gathered onto ``li``'s device."""
    out = []
    for dev, rows in _scene_blocks(mesh, axis, li.shape[0]):
        out.append(_search_device_batch(
            *_replicas(mesh, dev, tmpl_lines, tmpl_mask),
            *_on(dev, pair_t[rows], pair_tl[rows], pair_sl[rows], scenes[rows],
                 li[rows], angles, scene_tr[rows], feature_size[rows]),
            mode=mode, window=window, dense_steps=dense_steps,
            cand_ok=None if cand_ok is None else cand_ok[rows].to(dev)))
    return tuple(_gather(parts, li.device, dim=0) for parts in zip(*out))


def _genpairs_topk_sharded(mesh, tmpl_lines, tmpl_mask, top_vals, ord_t,
                           rank_ok, scenes, slen, svalid, li, angles, scene_tr,
                           feature_size, lengths, tau, *, axis="scene",
                           **static):
    """Scene-data-parallel :func:`_search_device_batch_topk_genpairs` (JAX
    ``match._genpairs_topk_sharded``): each ``mesh[axis]`` block of scenes
    generates its pairs and ranks them on its device; the bank tables are
    replicated; no collective but the final gather onto ``li``'s
    device."""
    out = []
    for dev, rows in _scene_blocks(mesh, axis, li.shape[0]):
        out.append(_search_device_batch_topk_genpairs(
            *_replicas(mesh, dev, tmpl_lines, tmpl_mask, top_vals, ord_t,
                       rank_ok),
            *_on(dev, scenes[rows], slen[rows], svalid[rows], li[rows], angles,
                 scene_tr[rows], feature_size[rows]),
            mesh.replica(lengths, dev), tau, **static))
    return tuple(_gather(parts, li.device, dim=0) for parts in zip(*out))


def search(matcher, searcher, optimizer, featuremap, templates, scene,
           mesh=None) -> list:
    """Find matches of ``templates`` in ``scene`` on ``featuremap``'s device
    (reference ``defaultmatch.cpp:32-89``).  Returns an UNSORTED list of
    :class:`Match` in reference emplace order (pair-major,
    polarity-minor), scored on the window kernel of the current generation.

    ``templates``: host line arrays, or a :class:`TemplateBank` on the
    feature map's device.  ``mesh``: an optional
    :class:`~openfdcm_tpu_torch.parallel.Mesh` with a ``"cand"`` axis: the
    candidates are split across it, each shard walks its own against the
    replicated stack (:func:`~openfdcm_tpu_torch.parallel.optimize_candidates_sharded`),
    with the same result."""
    del matcher                     # single strategy, kept for API parity
    from .pipeline import Dt3FeaturemapBatch, _search_batch_arrays
    dev = featuremap.dt3.device
    if mesh is not None:
        mesh.require_local("search")
        mesh.resolve(dev)           # the feature map's device is in the mesh
    bank = templates if isinstance(templates, TemplateBank) \
        else prepare_templates(templates, device=dev)
    if bank.device != dev:
        raise ValueError(f"template bank on {bank.device}, feature map on {dev}")
    scene_arr = geo.as_lines_np(scene) if np.asarray(scene).size \
        else np.zeros((0, 4), np.float32)
    if not bank.host or scene_arr.shape[0] == 0 \
            or featuremap.feature_size == (0, 0):
        return []
    if mesh is not None:
        pairs, scores, mats, valid = _search_cand_sharded(
            mesh, searcher, optimizer, featuremap, bank, scene_arr)
    else:
        one = Dt3FeaturemapBatch(
            dt3=featuremap.dt3[None], angles=featuremap.angles,
            scene_translations=featuremap.scene_translation[None],
            feature_sizes=(tuple(featuremap.feature_size),),
            params=featuremap.params)
        (pairs, scores, mats, valid), = _search_batch_arrays(
            searcher, optimizer, one, bank, [scene_arr])
    return [Match(int(pairs[j // 2, 0]), float(scores[j]), mats[j].copy())
            for j in range(2 * pairs.shape[0]) if valid[j]]


def _scene_candidates(bank, pairs, scene_arr, pb):
    """One scene's candidates from its host ``pairs (P, 3)`` padded to ``pb``
    pairs, on the bank's device: ``(cand_lines (2pb, L, 4), cand_mask (2pb,
    L), cand_align (2pb, 2), transforms (2pb, 2, 3), cand_ok (2pb,))``, the
    padding's candidates not ok.  As :func:`_search_device_batch` makes
    them."""
    dev = bank.device
    padded = np.zeros((pb, 3), np.int64)
    padded[: pairs.shape[0]] = pairs
    scene_pad = np.zeros((_bucket(scene_arr.shape[0], 128), 4), np.float32)
    scene_pad[: scene_arr.shape[0]] = scene_arr
    as_dev = lambda a: torch.as_tensor(a, device=dev)
    pt = as_dev(padded[:, 0])
    aligned, transforms, align_vecs = _make_candidates(
        bank.lines, pt[None], as_dev(padded[None, :, 1]),
        as_dev(padded[None, :, 2]), as_dev(scene_pad)[None])
    c = 2 * pb
    return (aligned.reshape(c, bank.lmax, 4),
            bank.mask[pt].repeat_interleave(2, dim=0),
            align_vecs[0].repeat_interleave(2, dim=0),
            transforms.reshape(c, 2, 3),
            (torch.arange(pb, device=dev) < pairs.shape[0]).repeat_interleave(2))


def _search_cand_sharded(mesh, searcher, optimizer, featuremap, bank, scene_arr):
    """One scene's host pairs, padded to a multiple of ``lcm(64, n_cand)``
    (JAX ``match.search``), their candidates split along the mesh's
    ``"cand"`` axis: ``(pairs, scores, mats, valid)`` as host arrays."""
    from ..parallel.sharded import optimize_candidates_sharded
    from . import optimize as opt
    from .pipeline import _bank_pairs_for_scene
    pairs = _bank_pairs_for_scene(searcher, bank, scene_arr)
    pb = _bucket(max(pairs.shape[0], 1), int(np.lcm(64, mesh.axis_size("cand"))))
    cand_lines, cand_mask, cand_align, transforms, ok = _scene_candidates(
        bank, pairs, scene_arr, pb)
    mode, window = opt.optimizer_mode(optimizer)
    w, h = featuremap.feature_size
    _, ph, pw = featuremap.dt3.shape
    scores, translations, valid = optimize_candidates_sharded(
        mesh, featuremap.dt3.reshape(-1), featuremap.angles,
        featuremap.scene_translation, (ph, pw),
        torch.tensor([float(w), float(h)], device=bank.device), cand_lines,
        cand_mask, cand_align, mode=mode, window=max(window, 1),
        dense_steps=opt.dense_step_count(optimizer, max(w, h)), cand_ok=ok)
    mats = transforms.clone()
    mats[..., 2] += translations
    return (pairs, scores.cpu().numpy(), mats.cpu().numpy(),
            valid.cpu().numpy())
