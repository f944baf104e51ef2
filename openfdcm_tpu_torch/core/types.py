"""Shared enums and small value types (port of :mod:`openfdcm_tpu.core.types`)."""
from __future__ import annotations

import enum


class Distance(enum.IntEnum):
    """Distance metric for the transform.  Reference ``core/imgproc.h:148``."""
    L2 = 0
    L2_SQUARED = 1
    L1 = 2


# Float32 max — the reference initializes DT images to
# ``std::numeric_limits<T>::max()`` (``core/imgproc.h:174``).
F32_MAX = 3.4028234663852886e38
