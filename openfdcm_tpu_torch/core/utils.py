"""Sorting/search utilities mirroring the reference (``core/math.h:76-159``);
a copy of :mod:`openfdcm_tpu.core.utils` (host numpy)."""
from __future__ import annotations

import numpy as np


def argsort(vec, descending: bool = False) -> list:
    """Indices sorting ``vec``, stable (reference ``argsort``,
    ``core/math.h:76-128``); ``descending=True`` is the reference's
    ``std::greater`` comparator."""
    arr = np.asarray(vec).reshape(-1)
    order = np.argsort(-arr if descending else arr, kind="stable")
    return [int(i) for i in order]


def binary_search(sorted_vec, value, descending: bool = False) -> int:
    """Index of the closest value in a sorted vector (reference
    ``binarySearch``, ``core/math.h:130-159``): ``lower_bound``, then the
    closer of it and its predecessor (ties to the predecessor)."""
    arr = np.asarray(sorted_vec).reshape(-1)
    n = len(arr)
    if descending:
        i = int(np.searchsorted(-arr, -value, side="left"))
    else:
        i = int(np.searchsorted(arr, value, side="left"))
    if i == 0:
        return 0
    if i == n:
        return n - 1
    return i if abs(value - arr[i]) < abs(value - arr[i - 1]) else i - 1
