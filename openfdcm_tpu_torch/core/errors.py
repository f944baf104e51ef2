"""Error types mirroring the reference (``core/error.h:32-50``); a copy of
:mod:`openfdcm_tpu.core.errors`.

The compute paths never raise: failures are values (NaN / inf scores,
invalid-candidate masks).  These exceptions appear only at API edges.
"""


class OpenFDCMError(Exception):
    """Base class for openfdcm_tpu_torch errors."""


class PointOutOfBound(OpenFDCMError):
    """A point lies outside the feature map (reference ``error.h:34-40``)."""


class ImgProcError(OpenFDCMError):
    """Image-processing failure (reference ``error.h:42-48``)."""
