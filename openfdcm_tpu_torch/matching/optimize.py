"""1D translation optimizers (port of :mod:`openfdcm_tpu.matching.optimize`).

The reference's greedy line searches walk away from the aligned position
in unit steps of the rasterized alignment vector and keep the best visited
step.  All candidates advance in lockstep; the per-candidate break/keep
logic is vectorized mask algebra.  The slice carries BatchOptimize
(``batchoptimize.cpp:48-94``); its lockstep walk is a Python loop whose
condition is one device-to-host sync (counted on :func:`host_sync`).
"""
from __future__ import annotations

import dataclasses

import torch

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
    max_steps: int | None = None


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


def require_batch_mode(mode: str) -> None:
    """The port carries BatchOptimize only so far."""
    if mode != "batch":
        raise NotImplementedError(
            f"optimizer mode {mode!r} is not ported yet (ROADMAP Queue 1 #5: "
            "Default/Indulgent/Dense optimizers); use BatchOptimize")


def host_sync(t: torch.Tensor):
    """``t.item()`` — a device-to-host sync, counted in ``host_sync.count``."""
    host_sync.count += 1
    return t.item()


host_sync.count = 0


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
    idx = t0[:, None] + torch.arange(h, dtype=torch.float32, device=scores.device)[None, :]
    vv = idx <= t_limit[:, None]
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
    while host_sync((~state[3]).any()):
        prev, best, bmul, done, t0 = state
        scores = eval_window(t0)
        bmin, barg, last, _ = _batch_stats(scores, t_limit, t0, batch)
        prev, best, bmul, done = _batch_step(
            (prev, best, bmul, done), (bmin[:, 0], barg[:, 0], last[:, 0], t0),
            sign=sign, batch=batch, t_limit=t_limit)
        state = (prev, best, bmul, done, t0 + batch)
    return state
