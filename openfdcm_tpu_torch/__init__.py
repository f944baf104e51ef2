"""openfdcm_tpu_torch: Fast Directional Chamfer Matching in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

A port of :mod:`openfdcm_tpu` (the JAX package, which stays the reference).
This package imports ``torch`` and never ``jax``.  It carries the matching
API: the DT3 build (kernels K2 min-plus EDT row pass, K3 orientation
propagation, K4 line-integral sweep), single-scene and scene-batched;
DefaultSearch and ConcentricRangeStrategy pair generation; the Default,
Indulgent, Batch and Dense optimizers on the window-score kernels (K1, and
K5/K6 under window generations 2/3); penalties; ``match_many`` with a
device-side top-k or host ranking; and the reference-shaped ``search``,
``optimize``, ``evaluate`` and ``penalize``.  Around it: line-file I/O,
the geometry, rasterize and draw helpers, :class:`MatcherService`
(serving), :func:`resumable_sweep`, the pose stage (:mod:`.pose`),
sharding across a device mesh (:mod:`.parallel`),
:mod:`.viz`, the drop-in :mod:`.compat` (``import openfdcm_tpu_torch.compat
as openfdcm``) and the CLI (``python -m openfdcm_tpu_torch``).  Every
kernel wrapper runs the CUDA kernel on CUDA tensors and its plain PyTorch
version on CPU tensors; entry points take an explicit ``device`` (default
``"cuda"``) or use their feature map's or bank's device.
"""
from .core.types import Distance
from .core import geometry, io, utils
from .core.errors import OpenFDCMError, PointOutOfBound, ImgProcError
from .core.io import read, write
from .core.geometry import get_template_lengths
from .matching.featuremap import (
    Dt3Params, Dt3Featuremap, build_featuremap, evaluate, minmax_translation,
    save_featuremap, load_featuremap,
)
from . import profiling
from .matching.search import (
    DefaultSearch, ConcentricRangeStrategy, establish_search_strategy,
)
from .matching.optimize import (
    DefaultOptimize, IndulgentOptimize, BatchOptimize, DenseOptimize, optimize,
)
from .matching.penalty import DefaultPenalty, ExponentialPenalty, penalize
from .matching.match import (
    Match, DefaultMatch, sort_matches, TemplateBank, prepare_templates, search,
)
from .matching.pipeline import (
    Dt3FeaturemapBatch, build_featuremap_batch, match_many, match_many_async,
    search_batch,
)
from .profiling import StageTimer
from .sweep import resumable_sweep, SweepState
from .serving import MatcherService
from . import convert, parallel

# The reference spells the enum `openfdcm.distance`.
distance = Distance

__version__ = "0.1.0"
# The reference exposes OPENFDCM_VER_{MAJOR,MINOR,PATCH} (core/version.h.in:28-32).
version_info = tuple(int(p) for p in __version__.split("."))

__all__ = [
    "Distance", "distance", "read", "write", "get_template_lengths",
    "Dt3Params", "Dt3Featuremap", "build_featuremap", "evaluate",
    "save_featuremap", "load_featuremap", "profiling",
    "minmax_translation", "DefaultSearch", "ConcentricRangeStrategy",
    "establish_search_strategy", "DefaultOptimize", "IndulgentOptimize",
    "BatchOptimize", "DenseOptimize", "optimize", "DefaultPenalty",
    "ExponentialPenalty", "penalize", "Match", "DefaultMatch", "search",
    "sort_matches", "TemplateBank", "prepare_templates", "geometry", "io",
    "Dt3FeaturemapBatch", "build_featuremap_batch", "search_batch", "match_many",
    "match_many_async",
    "resumable_sweep", "SweepState", "MatcherService",
    "OpenFDCMError", "PointOutOfBound", "ImgProcError", "utils",
    "version_info", "StageTimer", "convert",
]
