"""Status-code discipline for the whole suite.

Mirrors the reference's graceful-failure semantics (SURVEY.md §5):
CHOLMOD keeps ``Common.status`` and marks ``L.minor`` on a
not-positive-definite failure (reference: CHOLMOD/Include/cholmod_core.h:1681-1684);
KLU returns KLU_SINGULAR and can continue (reference: KLU/Include/klu.h:165);
UMFPACK warns on singularity but still produces a usable factorization.

We reproduce this as: every high-level operation records a :class:`Status`
into the ``Common`` it was given, raises only for *programming* errors
(invalid inputs), and returns partial results for *numerical* failures.
"""
from __future__ import annotations

import enum


class Status(enum.IntEnum):
    """Operation status. Negative = error, positive = warning, 0 = OK."""

    OK = 0
    # Warnings (result is usable, possibly degraded)
    NOT_POSDEF = 1          # Cholesky hit a non-positive pivot; factor valid up to `minor`
    SINGULAR = 2            # LU/QR detected (numerical) singularity
    DSMALL = 3              # tiny diagonal entries were perturbed (LDL / dbound)
    # Errors (no usable result)
    INVALID = -1            # invalid input matrix / arguments
    OUT_OF_MEMORY = -2
    NOT_AVAILABLE = -3      # feature gated out (e.g. native lib missing)
    TOO_LARGE = -4          # problem exceeds integer/shape limits

    @property
    def is_error(self) -> bool:
        return int(self) < 0

    @property
    def is_warning(self) -> bool:
        return int(self) > 0


class SparseError(ValueError):
    """Raised for invalid inputs (programming errors), never for numerical failure."""

    def __init__(self, status: Status, message: str):
        super().__init__(f"{status.name}: {message}")
        self.status = status


class NotPositiveDefiniteWarning(UserWarning):
    pass


class SingularMatrixWarning(UserWarning):
    pass
