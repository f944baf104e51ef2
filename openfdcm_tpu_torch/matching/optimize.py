"""1D translation optimizers (port of :mod:`openfdcm_tpu.matching.optimize`).

The reference's greedy line searches walk away from the aligned position
in unit steps of the rasterized alignment vector and keep the best visited
step.  All candidates advance in lockstep; the per-candidate break/keep
decisions over a scored window (:mod:`openfdcm_tpu_torch.ops.walk`: one
kernel launch on the card, vectorized mask algebra on the CPU) follow the
greedy walks (DefaultOptimize, IndulgentOptimize:
``defaultoptimize.cpp:15-69``) and BatchOptimize
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

from ..ops import walk as wkw
from ..profiling import count, span


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


def _walk_args(optimizer, extent: int) -> dict:
    """The ``mode``, ``window`` (at least 1) and ``dense_steps`` keyword
    arguments of every optimize call for ``optimizer`` on a canvas whose
    largest logical side is ``extent``."""
    mode, window = optimizer_mode(optimizer)
    return dict(mode=mode, window=max(window, 1),
                dense_steps=dense_step_count(optimizer, extent))


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
    w, h = featuremap.feature_size
    scores, trans, valid = optimize_candidates(
        featuremap.dt3.reshape(-1), featuremap.angles,
        featuremap.scene_translation, featuremap.dt3.shape[1:],
        np.asarray([w, h], np.float32), lines, mask,
        np.asarray(alignments, np.float32).reshape(c, 2),
        **_walk_args(optimizer, max(w, h)))
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


def _lockstep_walk(eval_window, t_limit, state, sign, batch=None):
    """Lockstep walk continuing from ``state = (prev, best, bmul, done,
    t_next)``; ``eval_window(t0)`` gives ``(C, H)`` scores at steps ``t0 +
    i``, every one evaluated.  Each window's decisions are one
    :func:`~openfdcm_tpu_torch.ops.walk.decide_window`: the greedy walk
    (``batch`` None) or BatchOptimize's whole batches of ``batch`` steps;
    every candidate then resumes after them, as in the JAX package's walk.
    One host sync per window."""
    with span("walks.loop"):
        while _any_live(state):
            t0 = state[4]
            scores = eval_window(t0)
            h = scores.shape[1]
            state = wkw.decide_window(scores, t_limit, t0 + (h - 1), state,
                                      sign, batch)
            if batch is None:           # finished walks move on too
                state = state[:4] + (t0 + h,)
    return state


def _greedy_walk(eval_window, t_limit, state, sign, window):
    """Lockstep greedy walk (Default/Indulgent semantics) continuing from
    ``state = (prev, best, bmul, done, t_next)``; ``eval_window(t0)`` gives
    ``(C, window)`` scores at steps ``t0 + i``.  One host sync per window."""
    return _lockstep_walk(eval_window, t_limit, state, sign)


def _batch_walk(eval_window, t_limit, state, sign, batch):
    """Lockstep BatchOptimize walk continuing from ``state = (prev, best,
    bmul, done, t_next)``; one host sync per window of whole batches of
    ``batch`` steps."""
    return _lockstep_walk(eval_window, t_limit, state, sign, batch)
