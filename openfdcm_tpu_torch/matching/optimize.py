"""1D translation optimizers (port of :mod:`openfdcm_tpu.matching.optimize`).

The reference's greedy line searches walk away from the aligned position
in unit steps of the rasterized alignment vector and keep the best visited
step.  All candidates advance in lockstep; the per-candidate break/keep
logic is vectorized mask algebra: the greedy walks (DefaultOptimize,
IndulgentOptimize: ``defaultoptimize.cpp:15-69``) and BatchOptimize
(``batchoptimize.cpp:48-94``).  Each lockstep walk is a Python loop whose
condition is one device-to-host sync (counted on :func:`host_sync`).
DenseOptimize, the JAX package's own addition, takes the global argmin over
every legal step; it needs no host sync.

The walks and the dense sweep run on the window kernels in
:mod:`.optimize_kernel`; :func:`optimize` is the reference-shaped entry.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..profiling import count, span

_BIG = 3.0e38


@dataclasses.dataclass(frozen=True)
class DefaultOptimize:
    """Greedy unit-step walk, break on first worsening score
    (``defaultoptimize.cpp:15-69``)."""
    window: int = 32


@dataclasses.dataclass(frozen=True)
class IndulgentOptimize:
    """Reference ``indulgentoptimize.cpp``."""
    indulgent_number_of_passthroughs: int = 0
    window: int = 32

    def get_number_of_passthroughs(self) -> int:
        return self.indulgent_number_of_passthroughs


@dataclasses.dataclass(frozen=True)
class BatchOptimize:
    """Greedy walk over batches of ``batch_size`` steps; keeps each batch's
    argmin; breaks when a batch min worsens the last kept score or rises
    within the batch (``batchoptimize.cpp:48-94``)."""
    batch_size: int = 10

    def get_batch_size(self) -> int:
        return self.batch_size


@dataclasses.dataclass(frozen=True)
class DenseOptimize:
    """Global argmin over the full legal translation range."""
    max_steps: int | None = None   # None: bound by the canvas extent


OptimizerLike = (DefaultOptimize, IndulgentOptimize, BatchOptimize, DenseOptimize)


def optimizer_mode(optimizer) -> tuple[str, int]:
    """(mode, window) for a strategy config."""
    if isinstance(optimizer, DenseOptimize):
        return "dense", 0
    if isinstance(optimizer, BatchOptimize):
        return "batch", optimizer.batch_size
    if isinstance(optimizer, IndulgentOptimize):
        return "indulgent", optimizer.window
    if isinstance(optimizer, DefaultOptimize):
        return "default", optimizer.window
    raise TypeError(f"unknown optimizer {optimizer!r}")


def dense_step_count(optimizer, max_wh: int) -> int:
    """Steps per direction of the dense sweep: the canvas extent (every
    legal translation), or ``DenseOptimize.max_steps`` when the user bounds
    the sweep, rounded up to whole 64-step windows (JAX
    ``optimize.dense_step_count``)."""
    mode, _ = optimizer_mode(optimizer)
    if mode != "dense":
        return 1
    steps = int(max_wh)
    if getattr(optimizer, "max_steps", None) is not None:
        steps = min(steps, int(optimizer.max_steps))
    return -(-max(steps, 1) // 64) * 64


def optimize_candidates(dt3_flat, angles, scene_tr, hw, feature_size,
                        tmpl_lines, line_mask, align_vecs, *, mode: str,
                        window: int, dense_steps: int, take_fn=None):
    """Optimize the aligned candidates of one scene at once, on the stack's
    device (JAX ``optimize.optimize_candidates``).

    ``dt3_flat``: the scene's flattened ``(D, *hw)`` LI stack; ``angles``
    ``(D,)``; ``scene_tr`` and ``feature_size`` (the logical ``(w, h)``)
    ``(2,)``; ``tmpl_lines (C, L, 4)`` aligned templates, ``line_mask (C,
    L)``, ``align_vecs (C, 2)`` raw alignment vectors; ``mode``, ``window``
    and ``dense_steps`` as :func:`optimizer_mode` and
    :func:`dense_step_count` give them.  A null alignment vector or a
    template already outside the canvas gives ``valid = False``.  Runs
    :func:`~.optimize_kernel.optimize_candidates_batch_kernel` on a batch of
    one scene: the window kernel of its generation (K1, K5 or K6) on the
    tiled copy, and K1 for the walks and the dense sweep.

    ``take_fn``: the JAX package's probe gather, ``take_fn(dt3_flat,
    idx)``, given every probe's unclamped flat index ``(2, L, C * K)``
    (endpoint, line, candidate-major lane) and returning their values as a
    clamped gather would.  With one, every window runs K1's arithmetic in
    plain ops through it (the JAX package's runs XLA there, not Pallas);
    ``None`` runs the kernels.

    Returns ``(scores (C,), translations (C, 2), valid (C,))``."""
    from .optimize_kernel import optimize_candidates_batch_kernel
    take = None if take_fn is None else lambda idx: take_fn(dt3_flat, idx)
    dev = dt3_flat.device
    as_dev = lambda x, dtype=torch.float32: torch.as_tensor(x, dtype=dtype,
                                                            device=dev)
    out = optimize_candidates_batch_kernel(
        dt3_flat.reshape(1, -1, *hw), as_dev(angles),
        as_dev(scene_tr).reshape(1, 2), as_dev(feature_size).reshape(1, 2),
        as_dev(tmpl_lines)[None], as_dev(line_mask, torch.bool)[None],
        as_dev(align_vecs)[None], mode=mode, window=window,
        dense_steps=dense_steps, take=take)
    return tuple(x[0] for x in out)


def optimize(optimizer, templates, alignments, featuremap):
    """Reference-shaped entry (``optimizestrategy.h:132``): a list of
    aligned templates and their alignment vectors against one
    :class:`~.featuremap.Dt3Featuremap`, on that feature map's device ->
    a list of ``None | (score, translation (2,))``."""
    from ..core import geometry as geo
    if not templates:
        return []
    if featuremap.feature_size == (0, 0):
        return [None] * len(templates)
    arrs = [geo.as_lines_np(t) for t in templates]
    c = len(arrs)
    lmax = max(max(a.shape[0] for a in arrs), 1)
    lines = np.zeros((c, lmax, 4), np.float32)
    mask = np.zeros((c, lmax), bool)
    for i, a in enumerate(arrs):
        lines[i, :a.shape[0]] = a
        mask[i, :a.shape[0]] = True
    mode, window = optimizer_mode(optimizer)
    w, h = featuremap.feature_size
    scores, trans, valid = optimize_candidates(
        featuremap.dt3.reshape(-1), featuremap.angles,
        featuremap.scene_translation, featuremap.dt3.shape[1:],
        np.asarray([w, h], np.float32), lines, mask,
        np.asarray(alignments, np.float32).reshape(c, 2), mode=mode,
        window=max(window, 1), dense_steps=dense_step_count(optimizer, max(w, h)))
    scores, trans, valid = (scores.cpu().numpy(), trans.cpu().numpy(),
                            valid.cpu().numpy())
    return [(float(scores[i]), trans[i].copy()) if valid[i] else None
            for i in range(c)]


def host_sync(t: torch.Tensor):
    """``t.item()`` — a device-to-host sync, counted in ``host_sync.count``
    and recorded as span ``walks.sync``."""
    host_sync.count += 1
    with span("walks.sync"):
        return t.item()


def _any_live(state) -> bool:
    """Whether a lockstep walk has a live candidate (one host sync); a true
    read is one more window, counted in ``walks.windows``."""
    live = host_sync((~state[3]).any())
    if live:
        count("walks.windows")
    return live


host_sync.count = 0


def _first_true(mask):
    """Index of the first ``True`` per row of ``mask (C, K)`` (``K`` where
    none): an explicit first-occurrence rule on every device."""
    k = mask.shape[1]
    idx = torch.arange(k, device=mask.device).expand_as(mask)
    return torch.where(mask, idx, k).amin(dim=1)


def _chain_prefix(scores, prev_kept, valid):
    """Greedy-walk window logic, vectorized (JAX ``optimize._chain_prefix``).

    Given window ``scores (C, K)``, the previous kept score ``prev_kept
    (C,)`` and per-step validity, returns ``(k, wmin, wmin_idx, new_prev,
    any_stop)``: the kept prefix length (before the first ascent or invalid
    step), the first minimum over the kept prefix and its index, the last
    kept score, and whether the walk stopped inside this window.  The first
    stop and the first minimum are taken by index (:func:`_first_true`),
    not left to ``argmax``/``argmin`` tie rules."""
    k_win = scores.shape[1]
    prev = torch.cat([prev_kept[:, None], scores[:, :-1]], dim=1)
    stop = (scores > prev) | ~valid
    k = _first_true(stop)
    any_stop = k < k_win
    kept = torch.arange(k_win, device=scores.device)[None, :] < k[:, None]
    masked = torch.where(kept, scores, _BIG)
    wmin = masked.amin(dim=1)
    wmin_idx = _first_true(masked == wmin[:, None])
    last = torch.gather(masked, 1, torch.clamp_min(k - 1, 0)[:, None])[:, 0]
    new_prev = torch.where(k > 0, last, prev_kept)
    return k, wmin, wmin_idx, new_prev, any_stop


def _steps(t0, h):
    """Steps ``t0 + i``, ``i < h``, of a window: ``(C, h)`` f32."""
    return t0[:, None] + torch.arange(h, dtype=torch.float32, device=t0.device)[None, :]


def _greedy_decide(scores, valid, state, sign):
    """The greedy decisions on one window ``scores (C, H)`` at steps ``t0 ..
    t0+H-1`` with per-step ``valid``: ``(k, ended, prev, best, bmul)``, the
    kept step count, whether the walk stopped inside the window, and the
    carried state after it."""
    prev, best, bmul, _, t0 = state
    k, wmin, wmin_idx, new_prev, ended = _chain_prefix(scores, prev, valid)
    improve = wmin < best
    best = torch.where(improve, wmin, best)
    bmul = torch.where(improve, sign * (t0 + wmin_idx.to(torch.float32)), bmul)
    return k, ended, new_prev, best, bmul


def _greedy_chain(scores, t_limit, state, sign):
    """One vectorized greedy-walk window over precomputed ``scores (C, H)``
    from each candidate's ``t_next``: one :func:`_greedy_walk` iteration
    with ``window = H``, minus the eval."""
    done, t0 = state[3], state[4]
    h = scores.shape[1]
    valid = (_steps(t0, h) <= t_limit[:, None]) & ~done[:, None]
    _, ended, prev, best, bmul = _greedy_decide(scores, valid, state, sign)
    return prev, best, bmul, done | ended, t0 + h


def _greedy_walk(eval_window, t_limit, state, sign, window):
    """Lockstep greedy walk (Default/Indulgent semantics) continuing from
    ``state = (prev, best, bmul, done, t_next)``; ``eval_window(t0)`` gives
    ``(C, window)`` scores at steps ``t0 + i``.  One host sync per window."""
    with span("walks.loop"):
        while _any_live(state):
            state = _greedy_chain(eval_window(state[4]), t_limit, state, sign)
    return state


def _batch_step(carry, inp, *, sign, batch, t_limit):
    """One BatchOptimize batch decision (``batchoptimize.cpp:60-93``)."""
    prev, best, bmul, done = carry
    bmin, barg, last, t0b = inp
    active = ~done
    keep = active & ~(bmin > prev)          # break *before* keeping
    improve = keep & (bmin < best)
    best = torch.where(improve, bmin, best)
    bmul = torch.where(improve, sign * (t0b + barg), bmul)
    prev = torch.where(keep, bmin, prev)
    interior = keep & (bmin < last)         # break *after* keeping
    exhausted = (t0b + batch) > t_limit
    done = done | ~keep | interior | exhausted
    return prev, best, bmul, done


def _batch_stats(scores, t_limit, t0, batch):
    """Per-batch (min, argmin, last-valid, per-batch t0) over dense scores
    ``(C, H)`` starting at per-candidate multiplier ``t0``."""
    c, h = scores.shape
    nb = h // batch
    vv = _steps(t0, h) <= t_limit[:, None]
    masked = torch.where(vv, scores, _BIG).reshape(c, nb, batch)
    bmin, barg = masked.min(dim=2)
    n_valid = vv.reshape(c, nb, batch).sum(dim=2)
    last = torch.gather(masked, 2, torch.clamp_min(n_valid - 1, 0)[..., None])[..., 0]
    t0s = t0[None, :] + (torch.arange(nb, dtype=torch.float32,
                                      device=scores.device) * batch)[:, None]
    return bmin, barg.to(torch.float32), last, t0s


def _batch_walk(eval_window, t_limit, state, sign, batch):
    """Lockstep BatchOptimize walk continuing from ``state = (prev, best,
    bmul, done, t_next)``; one host sync per step of ``batch`` steps."""
    with span("walks.loop"):
        while _any_live(state):
            prev, best, bmul, done, t0 = state
            scores = eval_window(t0)
            bmin, barg, last, _ = _batch_stats(scores, t_limit, t0, batch)
            prev, best, bmul, done = _batch_step(
                (prev, best, bmul, done), (bmin[:, 0], barg[:, 0], last[:, 0], t0),
                sign=sign, batch=batch, t_limit=t_limit)
            state = (prev, best, bmul, done, t0 + batch)
    return state
