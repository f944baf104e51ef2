"""Matching layer (port of :mod:`openfdcm_tpu.matching`): feature maps,
match, search, optimize and penalty strategies, and the batched pipeline."""
from . import featuremap, match, optimize, penalty, pipeline, search  # noqa: F401
