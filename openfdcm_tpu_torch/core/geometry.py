"""Line geometry primitives in PyTorch (port of :mod:`openfdcm_tpu.core.geometry`).

A *line array* is a float32 tensor ``(..., 4)`` holding ``(x1, y1, x2, y2)``.

Two rules of the JAX package's numerics contract carry over without its
machinery:

* Divide is the plain IEEE op and sqrt is :func:`sqrt_f32`.  ``div_cr`` /
  ``sqrt_cr`` exist in the JAX package because the TPU's divide and sqrt
  are not correctly rounded; on the CPU they pass straight through
  (``geometry.py:139,166``).  PyTorch's f32 ``/`` is IEEE-rounded on the
  CPU and on CUDA, but its vectorized f32 CPU ``sqrt`` is not (see
  :func:`sqrt_f32`).
* Eager PyTorch runs every op as its own kernel, so a product always rounds
  to f32 before the add that consumes it.  The ``_pmul`` launder that keeps
  XLA:CPU from contracting mul+add into an FMA is not needed here
  (``tests/test_torch_search.py`` pins it).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .types import resolve_device

PI = math.pi
HALF_PI = math.pi / 2.0


def _f32(x, device) -> torch.Tensor:
    """``x`` as a float32 tensor: a tensor stays on its device, host data
    goes to ``device`` (resolved: the card unless the caller asks for the
    CPU)."""
    if torch.is_tensor(x):
        return x.to(torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=resolve_device(device))


def as_lines(lines, device="cuda") -> torch.Tensor:
    """Coerce input to a float32 ``(N, 4)`` line tensor.

    Accepts the reference's ``(4, N)`` layout (``core/math.h:66``) as well
    as ``(N, 4)``; a ``(4, 4)`` array is read as ``(N, 4)``.  A tensor keeps
    its device; host data goes to ``device``."""
    arr = _f32(lines, device)
    if arr.ndim == 1:
        arr = arr.reshape(1, 4)
    if arr.ndim == 2 and arr.shape[0] == 4 and arr.shape[1] != 4:
        arr = arr.T
    if arr.shape[-1] != 4:
        raise ValueError(f"line array must have a trailing axis of 4, got {tuple(arr.shape)}")
    return arr


def as_lines_np(lines) -> np.ndarray:
    """Coerce host input to a float32 ``(N, 4)`` numpy line array.

    Accepts the reference's ``(4, N)`` layout as well as ``(N, 4)``; a
    ``(4, 4)`` array is read as ``(N, 4)``.
    """
    arr = np.asarray(lines, dtype=np.float32)
    if arr.ndim == 1:
        arr = arr.reshape(1, 4)
    if arr.ndim == 2 and arr.shape[0] == 4 and arr.shape[1] != 4:
        arr = arr.T
    if arr.shape[-1] != 4:
        raise ValueError(f"line array must have a trailing axis of 4, got {arr.shape}")
    return arr


def get_template_lengths(templates) -> list:
    """Total line length per template (host numpy).  Reference ``core/math.h:319-324``."""
    out = []
    for t in templates:
        arr = np.asarray(t, dtype=np.float32)
        if arr.ndim == 2 and arr.shape[0] == 4 and arr.shape[1] != 4:
            arr = arr.T
        arr = arr.reshape(-1, 4)
        if arr.shape[0] == 0:
            out.append(0.0)
            continue
        d = arr[:, 2:4] - arr[:, 0:2]
        out.append(float(np.sum(np.sqrt(d[:, 0] ** 2 + d[:, 1] ** 2), dtype=np.float32)))
    return out


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root on every device.

    WHY: PyTorch's vectorized f32 ``sqrt`` on the CPU (AVX-512 build) is
    not IEEE-rounded — 2652 of the integers 1..499999 come out one ulp off
    numpy's — while the f64 square root is, and rounding an f64 root of an
    f32 value to f32 is exact (53 >= 2*24 + 2 bits)."""
    return torch.sqrt(x.double()).float()


def pow_f32(x: torch.Tensor, tau: float) -> torch.Tensor:
    """f32 ``x ** float32(tau)`` taken in f64 and rounded to f32, the same
    on every device: the penalty's power (reference
    ``exponentialpenalty.cpp:39-45``).

    WHY: f32 ``pow`` is not correctly rounded on the CPU or on CUDA, and
    each rounds differently (torch's CPU f32 ``pow`` and the JAX package's
    ``jnp.power`` disagree on 18,364 of 1M lengths in [1, 5000] at tau
    1.5).  A one-ulp change in a penalized score can swap two nearly tied
    templates in a top-k, so the host ranking path and the device top-k
    both take the power here."""
    return torch.pow(x.double(), float(np.float32(tau))).float()


def div_cr(a, b, device="cuda") -> torch.Tensor:
    """Correctly rounded f32 division ``a / b``, the same bits on every
    device.  Tensors keep their device; host data goes to ``device`` (``b``
    to ``a``'s).

    The JAX package's ``div_cr`` corrects its backend's quotient by a search
    over the neighbouring floats with exact Dekker residuals, because the
    TPU divides by a reciprocal and Newton steps (1 ulp off on about a third
    of its inputs).  That search is not needed here: the CPU's and CUDA's
    f32 ``/`` are IEEE-rounded (PyTorch builds its CUDA kernels without
    fast math), so the plain quotient is already the one the search picks
    (``chip_smoke.phase_ieee`` holds the card's against numpy)."""
    a = _f32(a, device)
    return a / _f32(b, a.device)


def sqrt_cr(x, device="cuda") -> torch.Tensor:
    """Correctly rounded f32 square root, the same bits on every device:
    :func:`sqrt_f32`.  The JAX package's ``sqrt_cr`` runs the residual
    search of :func:`div_cr` over the TPU's approximate root; here the f64
    root rounded to f32 is already the correctly rounded one (the vectorized
    f32 ``torch.sqrt`` on the CPU is not: see :func:`sqrt_f32`)."""
    return sqrt_f32(_f32(x, device))


def p1(lines: torch.Tensor) -> torch.Tensor:
    """First endpoint, ``(..., 2)``.  Reference ``core/math.h:282``."""
    return lines[..., 0:2]


def p2(lines: torch.Tensor) -> torch.Tensor:
    """Second endpoint, ``(..., 2)``.  Reference ``core/math.h:283``."""
    return lines[..., 2:4]


def get_center(lines: torch.Tensor) -> torch.Tensor:
    """Midpoint of each line, ``(..., 2)``.  Reference ``core/math.h:286-288``."""
    return (lines[..., 0:2] + lines[..., 2:4]) * 0.5


def get_angle(lines: torch.Tensor) -> torch.Tensor:
    """Angle of each line in ``[-pi/2, pi/2]``, ``(...,)``: ``atan(dy/dx)``,
    not atan2 (reference ``core/math.h:295-299``), so a vertical line gives
    ``+-pi/2`` and a point NaN.  ``torch.atan`` may differ from XLA's by one
    ulp; the matching path never calls it (it classifies in ratio space)."""
    d = p2(lines) - p1(lines)
    return torch.atan(d[..., 1] / d[..., 0])


def get_length(lines: torch.Tensor) -> torch.Tensor:
    """Euclidean length of each line, ``(...,)``.  Reference ``core/math.h:306-308``."""
    d = p2(lines) - p1(lines)
    return sqrt_f32(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])


def normalize(lines: torch.Tensor) -> torch.Tensor:
    """Unit direction of each line, ``(..., 2)``; a zero-length line gives
    ``(0, 0)`` (Eigen ``normalized()``).  Reference ``core/math.h:331-333``."""
    d = lines[..., 2:4] - lines[..., 0:2]
    n = sqrt_f32(d[..., 0:1] * d[..., 0:1] + d[..., 1:2] * d[..., 1:2])
    pos = n > 0
    return torch.where(pos, d / torch.where(pos, n, torch.ones_like(n)),
                       torch.zeros_like(d))


def _apply2x2(rot: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Elementwise 2x2 matrix application, each product rounded to f32."""
    x = rot[..., 0, 0] * v[..., 0] + rot[..., 0, 1] * v[..., 1]
    y = rot[..., 1, 0] * v[..., 0] + rot[..., 1, 1] * v[..., 1]
    return torch.stack([x, y], dim=-1)


def transform(lines: torch.Tensor, mat23: torch.Tensor) -> torch.Tensor:
    """Apply a ``(..., 2, 3)`` affine transform, broadcast against the
    lines' leading axes.  Reference ``core/math.h:341-344``."""
    rot = mat23[..., :2, :2]
    t = mat23[..., :2, 2]
    a = _apply2x2(rot, lines[..., 0:2]) + t
    b = _apply2x2(rot, lines[..., 2:4]) + t
    return torch.cat([a, b], dim=-1)


def align(alignment_line: torch.Tensor, ref_line: torch.Tensor) -> torch.Tensor:
    """The two rigid transforms aligning ``alignment_line`` onto ``ref_line``,
    ``(..., 2, 2, 3)`` (both polarities).  Reference ``core/math.h:387-406``."""
    td = normalize(alignment_line)
    ad = normalize(ref_line)
    cos = ad[..., 0] * td[..., 0] + ad[..., 1] * td[..., 1]
    sin = ad[..., 1] * td[..., 0] - ad[..., 0] * td[..., 1]
    center_a = get_center(alignment_line)
    center_r = get_center(ref_line)

    def mk(c, s):
        rot = torch.stack([torch.stack([c, -s], dim=-1),
                           torch.stack([s, c], dim=-1)], dim=-2)
        t = center_r - _apply2x2(rot, center_a)
        return torch.cat([rot, t[..., :, None]], dim=-1)

    return torch.stack([mk(cos, sin), mk(-cos, -sin)], dim=-3)


def translate(lines: torch.Tensor, translation) -> torch.Tensor:
    """Translate a line array by a 2-vector.  Reference ``core/math.h:352-354``."""
    t = _f32(translation, lines.device).to(lines.device)
    return lines + torch.cat([t, t], dim=-1)


def rotate(lines: torch.Tensor, rot, rot_point=None) -> torch.Tensor:
    """Rotate a line array by a 2x2 matrix, optionally about a point.
    Reference ``core/math.h:362-378``."""
    rot = _f32(rot, lines.device).to(lines.device)
    if rot_point is None:
        return torch.cat([_apply2x2(rot, p1(lines)), _apply2x2(rot, p2(lines))],
                         dim=-1)
    rot_point = _f32(rot_point, lines.device).to(lines.device)
    t = rot_point - _apply2x2(rot, rot_point)
    return transform(lines, torch.cat([rot, t[:, None]], dim=-1))


def combine(a, b, device="cuda") -> torch.Tensor:
    """Compose a 2x3 transform with a translation.

    ``combine(mat23, translation)``: the translation applied *before* the
    transform (reference ``core/math.h:414-419``); ``combine(translation,
    mat23)``: applied *after* (``core/math.h:427-432``).  Dispatch follows
    the trailing shape.  Host inputs go to the device of a tensor argument,
    else to ``device``."""
    dev = next((v.device for v in (a, b) if torch.is_tensor(v)), device)
    a, b = _f32(a, dev).to(dev), _f32(b, dev).to(dev)
    if a.ndim >= 2 and a.shape[-2:] == (2, 3):            # (mat, translation)
        rot = a[..., :2, :2]
        t = a[..., :2, 2] + _apply2x2(rot, b)
    else:                                                 # (translation, mat)
        rot = b[..., :2, :2]
        t = b[..., :2, 2] + a
    return torch.cat([rot, t[..., :, None]], dim=-1)


def minmax_point(lines: torch.Tensor):
    """Min and max corner of the bounding box over all endpoints, each
    ``(..., 2)``, reduced over the line axis.  Reference ``core/math.h:166-171``."""
    pts = lines.reshape(*lines.shape[:-1], 2, 2)
    return pts.amin(dim=(-3, -2)), pts.amax(dim=(-3, -2))


def constrain_half_angle(x, device="cuda") -> torch.Tensor:
    """Wrap angles to ``[-pi/2, pi/2)``.  Reference ``core/math.h:218-223``."""
    y = torch.fmod(_f32(x, device) + HALF_PI, PI)
    return y + PI * (y < 0) - HALF_PI


def constrain_angle(x, device="cuda") -> torch.Tensor:
    """Wrap angles to ``[-pi, pi)``.  Reference ``core/math.h:244-249``."""
    y = torch.fmod(_f32(x, device) + PI, 2 * PI)
    return y + 2 * PI * (y < 0) - PI


def wrap_max(x, mx, device="cuda") -> torch.Tensor:
    """Reference ``core/math.h:264-267``."""
    return torch.fmod(mx + torch.fmod(_f32(x, device), mx), mx)


def wrap_min_max(x, mn, mx, device="cuda") -> torch.Tensor:
    """Reference ``core/math.h:269-272``."""
    return mn + wrap_max(_f32(x, device) - mn, mx - mn)


def relatively_equal(a: torch.Tensor, b, rtol=1e-10,
                     atol=1.1920929e-07) -> torch.Tensor:
    """Reference ``core/math.h:183-188`` (default atol = f32 epsilon)."""
    b = torch.as_tensor(b, dtype=torch.float32, device=a.device)
    return (a - b).abs() <= atol + rtol * torch.maximum(a.abs(), b.abs())


def all_close(a, b, rtol=0.0, atol=1e-5) -> bool:
    """Reference ``core/math.h:203-208`` (host: tensors are read back)."""
    a = np.asarray(a.cpu() if torch.is_tensor(a) else a, np.float32)
    b = np.asarray(b.cpu() if torch.is_tensor(b) else b, np.float32)
    return bool(np.all(np.abs(a - b) <= (atol + rtol * np.abs(b))))
