"""Shared enums and small value types (port of :mod:`openfdcm_tpu.core.types`)."""
from __future__ import annotations

import enum

import torch


class Distance(enum.IntEnum):
    """Distance metric for the transform.  Reference ``core/imgproc.h:148``."""
    L2 = 0
    L2_SQUARED = 1
    L1 = 2


# Float32 max — the reference initializes DT images to
# ``std::numeric_limits<T>::max()`` (``core/imgproc.h:174``).
F32_MAX = 3.4028234663852886e38


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU.  ``cuda`` without an index names the current card; raises
    ``RuntimeError`` when CUDA is asked for and none is available."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {str(device)!r}: no CUDA device is "
                               "available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
