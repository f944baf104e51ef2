"""Core of the port: geometry, rasterization, drawing, distance transforms,
line integrals and line-file I/O (port of :mod:`openfdcm_tpu.core`)."""
from .types import Distance, F32_MAX
from . import geometry, rasterize, draw, dt, integral, io
