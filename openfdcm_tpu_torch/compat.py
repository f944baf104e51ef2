"""Drop-in compatibility layer mirroring the reference's ``import openfdcm``
(port of :mod:`openfdcm_tpu.compat`).

Every class, function, argument name and default matches the reference's
pybind11 module (``modules/python/src/matching.cpp:62-307``,
``core.cpp:39-50``), so reference user code runs unchanged:

    import openfdcm_tpu_torch.compat as openfdcm

Line arrays use the reference's ``4 x N`` column layout at this boundary
(both layouts are accepted on input; ``read`` returns ``4 x N``).

:func:`build_cpu_featuremap` takes one keyword beyond the reference's
signature, ``device`` (default ``"cuda"``): it is the one call here that
creates device state, and ``search`` runs on its feature map's device.  The
``ThreadPool`` exists for API parity only: the reference's thread fan-outs
(per-angle DT build, per-candidate optimize) are batched device work here.
"""
from __future__ import annotations

import numpy as np

from . import (
    Distance, Dt3Params, Dt3Featuremap, build_featuremap,
    DefaultSearch, ConcentricRangeStrategy, DefaultMatch,
    DefaultPenalty, ExponentialPenalty, Match,
)
from . import search as _search, penalize as _penalize, \
    sort_matches as _sort_matches, get_template_lengths as _get_template_lengths
from .core import io as _io
from .matching import optimize as _opt

__all__ = [
    "distance", "ThreadPool", "Dt3CpuParameters", "Dt3Cpu", "FeatureMap",
    "OptimizeStrategy", "DefaultOptimize", "IndulgentOptimize", "BatchOptimize",
    "PenaltyStrategy", "DefaultPenalty", "ExponentialPenalty",
    "SearchStrategy", "DefaultSearch", "ConcentricRangeStrategy",
    "MatchStrategy", "DefaultMatch", "Match",
    "build_cpu_featuremap", "search", "penalize", "get_template_lengths",
    "sort_matches", "read", "write",
]

distance = Distance


class ThreadPool:
    """API-parity stub for ``BS::thread_pool`` (``matching.cpp:86-101``);
    the pool carries no work."""

    def __init__(self, num_threads: int | None = None):
        self._num_threads = int(num_threads) if num_threads else 1

    def get_tasks_queued(self) -> int:
        return 0

    def get_tasks_running(self) -> int:
        return 0

    def get_tasks_total(self) -> int:
        return 0

    def get_thread_count(self) -> int:
        return self._num_threads

    def get_thread_ids(self):
        return []

    def purge(self) -> None:
        pass

    def __repr__(self):
        return f"<ThreadPool with {self._num_threads} threads>"


class Dt3CpuParameters:
    """Reference ``PyDt3CpuParameters`` (``matching.cpp:51-60,103-114``):
    mutable fields ``depth``, ``dt3_coeff``, ``padding``, ``distance``.
    The constructor also accepts the reference's camelCase ``dt3Coeff``."""

    def __init__(self, depth: int = 30, dt3_coeff: float = 5.0,
                 padding: float = 2.2, distance: Distance = Distance.L2,
                 **kwargs):
        if "dt3Coeff" in kwargs:
            dt3_coeff = kwargs.pop("dt3Coeff")
        if kwargs:
            raise TypeError(f"unexpected arguments: {sorted(kwargs)}")
        self.depth = int(depth)
        self.dt3_coeff = float(dt3_coeff)
        self.padding = float(padding)
        self.distance = distance

    def _params(self) -> Dt3Params:
        return Dt3Params(self.depth, self.dt3_coeff, self.padding, self.distance)

    def __repr__(self):
        return (f"<Dt3CpuParameters: depth={self.depth}, "
                f"dt3Coeff={self.dt3_coeff}, padding={self.padding}>")


class Dt3Cpu:
    """Reference ``Dt3Cpu`` feature map object (``matching.cpp:72-84``); the
    map itself stays on its device, the getters return host arrays."""

    def __init__(self, featuremap: Dt3Featuremap):
        self._fm = featuremap

    def get_scene_translation(self):
        return self._fm.scene_translation.cpu().numpy()

    def get_feature_size(self):
        return self._fm.feature_size

    def get_dt3_map(self):
        """The orientation-indexed bank as ``{angle: image}`` host arrays,
        mirroring the reference's ``Dt3CpuMap`` (``dt3cpu.h:44``)."""
        w, h = self._fm.feature_size
        arr = self._fm.dt3[:, :h, :w].cpu().numpy()
        return {float(a): arr[i] for i, a in enumerate(self._fm.angles.cpu().numpy())}

    def __repr__(self):
        w, h = self._fm.feature_size
        return f"<Dt3Cpu: feature size={w}x{h}>"


class FeatureMap:
    """Type-erased feature map wrapper (``matching.cpp:66-70``)."""

    def __init__(self, concrete: Dt3Cpu):
        self._concrete = concrete

    def __repr__(self):
        return "<FeatureMap>"


class _Erased:
    def __init__(self, concrete):
        self._concrete = concrete

    def __repr__(self):
        return f"<{type(self).__name__}>"


class OptimizeStrategy(_Erased):
    """``matching.cpp:137-143``."""


class SearchStrategy(_Erased):
    """``matching.cpp:213-218``."""


class MatchStrategy(_Erased):
    """``matching.cpp:251-256``."""


class PenaltyStrategy(_Erased):
    """``matching.cpp:187-192``."""


def _set_pool(obj, pool, num_threads) -> None:
    object.__setattr__(obj, "_pool",
                       pool if isinstance(pool, ThreadPool) else ThreadPool(num_threads))


class DefaultOptimize(_opt.DefaultOptimize):
    """Reference ctor: ``DefaultOptimize(pool)`` or
    ``DefaultOptimize(num_threads)`` (``matching.cpp:145-152``)."""

    def __new__(cls, pool=None, num_threads=None):
        return _opt.DefaultOptimize.__new__(cls)

    def __init__(self, pool=None, num_threads=None):
        super().__init__()
        _set_pool(self, pool, num_threads)

    def get_pool(self):
        return self._pool


class IndulgentOptimize(_opt.IndulgentOptimize):
    """``IndulgentOptimize(passthroughs, pool | num_threads)``
    (``matching.cpp:154-168``)."""

    def __new__(cls, indulgent_number_of_passthroughs, pool=None, num_threads=None):
        return _opt.IndulgentOptimize.__new__(cls)

    def __init__(self, indulgent_number_of_passthroughs, pool=None, num_threads=None):
        super().__init__(int(indulgent_number_of_passthroughs))
        _set_pool(self, pool, num_threads)

    def get_pool(self):
        return self._pool


class BatchOptimize(_opt.BatchOptimize):
    """``BatchOptimize(batch_size, pool | num_threads)``
    (``matching.cpp:170-185``)."""

    def __new__(cls, batch_size, pool=None, num_threads=None):
        return _opt.BatchOptimize.__new__(cls)

    def __init__(self, batch_size, pool=None, num_threads=None):
        super().__init__(int(batch_size))
        _set_pool(self, pool, num_threads)

    def get_pool(self):
        return self._pool


def _unwrap(strategy):
    return strategy._concrete if isinstance(strategy, _Erased) else strategy


def build_cpu_featuremap(scene, params: Dt3CpuParameters = None,
                         pool: ThreadPool | None = None, *,
                         device="cuda") -> Dt3Cpu:
    """Reference ``build_cpu_featuremap(scene, params, pool)``
    (``matching.cpp:116-130``), built on ``device``; the pool is accepted
    and ignored."""
    del pool
    if params is None:
        params = Dt3CpuParameters()
    p = params._params() if isinstance(params, Dt3CpuParameters) else params
    return Dt3Cpu(build_featuremap(np.asarray(scene, np.float32), p, device=device))


def search(matcher, searcher, optimizer, featuremap, templates, scene):
    """Reference ``search`` (``matching.cpp:279-289``), on the feature map's
    device."""
    fm = featuremap
    if isinstance(fm, FeatureMap):
        fm = fm._concrete
    if isinstance(fm, Dt3Cpu):
        fm = fm._fm
    return _search(_unwrap(matcher), _unwrap(searcher), _unwrap(optimizer),
                   fm, templates, scene)


def penalize(penalty, matches, templatelengths):
    """Reference ``penalize`` (``matching.cpp:291-297``)."""
    return _penalize(_unwrap(penalty), matches, templatelengths)


def get_template_lengths(templates):
    return _get_template_lengths(templates)


def sort_matches(matches):
    return _sort_matches(matches)


def write(filepath: str, lines) -> None:
    """Reference ``core.write`` (``core.cpp:41-44``): ``4 x N`` or ``N x 4``."""
    arr = np.asarray(lines, np.float32)
    if arr.ndim == 2 and arr.shape[0] == 4 and arr.shape[1] != 4:
        arr = arr.T
    _io.write(filepath, arr)


def read(filepath: str) -> np.ndarray:
    """Reference ``core.read`` (``core.cpp:46-49``): the ``4 x N`` layout."""
    return _io.read(filepath).T
