"""State carried across from the JAX package.

Turns a ``openfdcm_tpu`` ``TemplateBank`` or ``Dt3FeaturemapBatch``, handed
over as numpy arrays, into the port's counterpart on a given device — so a
search can run on a DT3 stack the JAX package built, and search parity can
be checked apart from build parity.  Nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.types import Distance, resolve_device
from .matching.featuremap import Dt3Params
from .matching.match import TemplateBank
from .matching.pipeline import Dt3FeaturemapBatch


def bank_from_numpy(lines, mask, host, lengths_np, counts_np,
                    device="cuda") -> TemplateBank:
    """A ``TemplateBank`` from a JAX bank's ``lines (T, lmax, 4)``, ``mask
    (T, lmax)``, ``host`` templates, ``lengths_np`` and ``counts_np``."""
    device = resolve_device(device)
    return TemplateBank(
        torch.as_tensor(np.array(lines, np.float32), device=device),
        torch.as_tensor(np.array(mask, bool), device=device),
        tuple(np.array(t, np.float32) for t in host),
        np.array(lengths_np, np.float32), np.array(counts_np, np.int64))


def featuremap_batch_from_numpy(dt3, angles, scene_translations, feature_sizes,
                                params, device="cuda") -> Dt3FeaturemapBatch:
    """A ``Dt3FeaturemapBatch`` from a JAX batch's ``dt3 (S, D, PH, PW)``,
    ``angles``, ``scene_translations``, ``feature_sizes`` and ``params``
    (any object with ``depth``, ``dt3_coeff``, ``padding`` and ``distance``)."""
    device = resolve_device(device)
    p = Dt3Params(int(params.depth), float(params.dt3_coeff),
                  float(params.padding), Distance(int(params.distance)))
    return Dt3FeaturemapBatch(
        dt3=torch.as_tensor(np.array(dt3, np.float32), device=device),
        angles=torch.as_tensor(np.array(angles, np.float32), device=device),
        scene_translations=torch.as_tensor(
            np.array(scene_translations, np.float32), device=device),
        feature_sizes=tuple((int(w), int(h)) for w, h in feature_sizes),
        params=p)
