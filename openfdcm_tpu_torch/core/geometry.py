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

import numpy as np
import torch


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


def get_center(lines: torch.Tensor) -> torch.Tensor:
    """Midpoint of each line, ``(..., 2)``.  Reference ``core/math.h:286-288``."""
    return (lines[..., 0:2] + lines[..., 2:4]) * 0.5


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


def relatively_equal(a: torch.Tensor, b, rtol=1e-10,
                     atol=1.1920929e-07) -> torch.Tensor:
    """Reference ``core/math.h:183-188`` (default atol = f32 epsilon)."""
    b = torch.as_tensor(b, dtype=torch.float32, device=a.device)
    return (a - b).abs() <= atol + rtol * torch.maximum(a.abs(), b.abs())
