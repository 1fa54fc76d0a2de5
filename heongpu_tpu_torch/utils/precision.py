"""CKKS precision statistics (copy of heongpu_tpu/utils/precision.py, numpy
only).

Given expected and decrypted slot vectors, report per-component (real /
imag / L2) error statistics as bits of precision (max / min / mean /
median), the way the reference prints them after bootstrapping examples.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class PrecisionStats:
    """Bits of precision: larger is better; -log2 of the error magnitude."""
    real_max: float
    real_min: float
    real_mean: float
    real_median: float
    imag_max: float
    imag_min: float
    imag_mean: float
    imag_median: float
    l2_bits: float

    def __str__(self):
        return (f"precision bits  real(mean/med/min/max)="
                f"{self.real_mean:.2f}/{self.real_median:.2f}/"
                f"{self.real_min:.2f}/{self.real_max:.2f}  "
                f"imag(mean)={self.imag_mean:.2f}  l2={self.l2_bits:.2f}")


def _bits(err: np.ndarray) -> np.ndarray:
    return -np.log2(np.maximum(err, 1e-300))


def precision_stats(expected, got) -> PrecisionStats:
    """expected/got: complex (or real) slot vectors of equal length."""
    e = np.asarray(expected, np.complex128)
    g = np.asarray(got, np.complex128)
    assert e.shape == g.shape
    dr = _bits(np.abs(e.real - g.real))
    di = _bits(np.abs(e.imag - g.imag))
    l2 = float(-math.log2(max(np.linalg.norm(e - g) / max(len(e), 1) ** 0.5,
                              1e-300)))
    return PrecisionStats(
        real_max=float(dr.max()), real_min=float(dr.min()),
        real_mean=float(dr.mean()), real_median=float(np.median(dr)),
        imag_max=float(di.max()), imag_min=float(di.min()),
        imag_mean=float(di.mean()), imag_median=float(np.median(di)),
        l2_bits=l2,
    )
