"""openfdcm_tpu_torch: Fast Directional Chamfer Matching in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

A port of :mod:`openfdcm_tpu` (the JAX package, which stays the reference).
This package imports ``torch`` and never ``jax``.  Its slice so far is the
``match_many`` main path: the DT3 build (kernels K2 min-plus EDT row pass,
K3 orientation propagation, K4 line-integral sweep), on-device pair
generation, BatchOptimize on the window-score kernel K1, and a device-side
penalize + top-k.  Every kernel wrapper runs the CUDA kernel on CUDA
tensors and its plain PyTorch version on CPU tensors; entry points take an
explicit ``device``.
"""
from .core.types import Distance
from .core.geometry import get_template_lengths
from .matching.featuremap import Dt3Params
from .matching.search import DefaultSearch
from .matching.optimize import (
    DefaultOptimize, IndulgentOptimize, BatchOptimize, DenseOptimize,
)
from .matching.penalty import DefaultPenalty, ExponentialPenalty
from .matching.match import (
    Match, DefaultMatch, sort_matches, TemplateBank, prepare_templates,
)
from .matching.pipeline import (
    Dt3FeaturemapBatch, build_featuremap_batch, match_many, match_many_async,
)
from .profiling import StageTimer
from . import convert

__version__ = "0.1.0"

__all__ = [
    "Distance", "get_template_lengths", "Dt3Params", "DefaultSearch",
    "DefaultOptimize", "IndulgentOptimize",
    "BatchOptimize", "DenseOptimize", "DefaultPenalty", "ExponentialPenalty",
    "Match", "DefaultMatch", "sort_matches", "TemplateBank",
    "prepare_templates", "Dt3FeaturemapBatch", "build_featuremap_batch",
    "match_many", "match_many_async", "StageTimer", "convert",
]
