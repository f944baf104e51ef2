"""Match visualization helpers (port of :mod:`openfdcm_tpu.viz`: the
reference notebook's drawing cells, ``pose_extimation_example.ipynb`` cell
9, as a library utility).

Host numpy rasterization by default; ``use_cv2=True`` draws with OpenCV
when it is installed (an optional dependency), as in the JAX package.
"""
from __future__ import annotations

import numpy as np

from .core import geometry as geo

__all__ = ["transformed_template", "draw_lines_image", "draw_matches"]


def transformed_template(template, transform) -> np.ndarray:
    """Apply a match's 2x3 transform to a template's ``(N, 4)`` lines."""
    t = geo.as_lines_np(template)
    m = np.asarray(transform, np.float32)
    r, tr = m[:2, :2], m[:2, 2]
    a = t[:, 0:2] @ r.T + tr
    b = t[:, 2:4] @ r.T + tr
    return np.concatenate([a, b], axis=1).astype(np.float32)


def draw_lines_image(lines, image=None, shape=None, value=255,
                     use_cv2: bool = False) -> np.ndarray:
    """Rasterize ``(N, 4)`` lines into a (new or given) uint8 image."""
    arr = geo.as_lines_np(lines)
    if image is None:
        if shape is None:
            hi = int(np.ceil(arr[:, 1::2].max())) + 2 if arr.size else 2
            wi = int(np.ceil(arr[:, 0::2].max())) + 2 if arr.size else 2
            shape = (hi, wi)
        image = np.zeros(shape, np.uint8)
    if use_cv2:
        try:
            import cv2
            for x1, y1, x2, y2 in arr:
                cv2.line(image, (int(round(x1)), int(round(y1))),
                         (int(round(x2)), int(round(y2))), int(value), 1)
            return image
        except ImportError:
            pass
    h, w = image.shape[:2]
    for x1, y1, x2, y2 in arr:
        n = max(int(np.hypot(x2 - x1, y2 - y1)) * 2, 1)
        xs = np.clip(np.round(np.linspace(x1, x2, n)).astype(int), 0, w - 1)
        ys = np.clip(np.round(np.linspace(y1, y2, n)).astype(int), 0, h - 1)
        image[ys, xs] = value
    return image


def draw_matches(scene, matches, templates, shape=None, top: int = 1,
                 use_cv2: bool = False) -> np.ndarray:
    """Scene lines (value 128) + the ``top`` matches' transformed templates
    (value 255) in one uint8 image: the notebook's ``display_best_match``
    as data instead of a plot."""
    img = draw_lines_image(scene, shape=shape, value=128, use_cv2=use_cv2)
    for m in matches[:top]:
        tl = transformed_template(templates[m.tmpl_idx], m.transform)
        draw_lines_image(tl, image=img, value=255, use_cv2=use_cv2)
    return img
