"""Log-space math: exact and LUT-interpolated logAdd.

The reference computes log(exp(d)+1) with a piecewise-cubic interpolation
(pairwiseAligner.c:279-299) to avoid transcendentals on CPU. Both forms are
provided: the exact one, and the cubic LUT form that the CLI uses by
default for agreement with the reference semantics (bit-level agreement of
DP recurrences requires it).

Both forms are jittable and accept arrays.
"""

from __future__ import annotations

import numpy as np

from margin_tpu.utils.lazyjax import jax, jnp

LOG_ZERO = -np.inf
LOG_ONE = 0.0

_LOG_UNDERFLOW_THRESHOLD = 7.5

# Piecewise cubic coefficients from pairwiseAligner.c:282-293,
# rows: x<=1.0, x<=2.5, x<=4.5, x<=7.5 ; columns: a,b,c,d of ((a*x+b)*x+c)*x+d
_CUBIC = np.array([
    [-0.009350833524763, 0.130659527668286, 0.498799810682272, 0.693203116424741],
    [-0.014532321752540, 0.139942324101744, 0.495635523139337, 0.692140569840976],
    [-0.004605031767994, 0.063427417320019, 0.695956496475118, 0.514272634594009],
    [-0.000458661602210, 0.009695946122598, 0.930734667215156, 0.168037164329057],
], dtype=np.float64)

_BREAKS = np.array([1.0, 2.5, 4.5], dtype=np.float64)


def _lookup(x):
    """Cubic-spline approximation of log(exp(x)+1) for 0 <= x <= 7.5
    (pairwiseAligner.c:282-293).

    The 4 coefficient rows are applied with branch-free selects, not a
    gather: this runs inside every DP-cell logAdd."""
    rows = [jnp.asarray(_CUBIC[i], dtype=x.dtype) for i in range(4)]

    def poly(c):
        return ((c[0] * x + c[1]) * x + c[2]) * x + c[3]

    v01 = jnp.where(x > _BREAKS[0], poly(rows[1]), poly(rows[0]))
    v23 = jnp.where(x > _BREAKS[2], poly(rows[3]), poly(rows[2]))
    return jnp.where(x > _BREAKS[1], v23, v01)


def log_add_lut(x, y):
    """logAdd with the reference's LUT semantics (pairwiseAligner.c:295-299).

    Returns max(x,y) when the difference exceeds 7.5 or the smaller is -inf.
    """
    x, y = jnp.asarray(x), jnp.asarray(y)
    hi = jnp.maximum(x, y)
    lo = jnp.minimum(x, y)
    d = hi - lo
    # d may be nan (inf - inf) or inf; clamp for the lookup then select.
    d_safe = jnp.clip(jnp.nan_to_num(d, posinf=0.0), 0.0, _LOG_UNDERFLOW_THRESHOLD)
    approx = _lookup(d_safe) + lo
    use_hi = jnp.isinf(lo) | (d >= _LOG_UNDERFLOW_THRESHOLD) | jnp.isnan(d)
    return jnp.where(use_hi, hi, approx)


def log_add_lut_finite(x, y):
    """log_add_lut for inputs known finite and non-NaN (DP kernels clamp
    at a finite LOG_ZERO): drops the isinf/isnan/nan_to_num guards, which
    roughly double the op count of the general form. For d >= 7.5 the
    polynomial may overflow harmlessly — the select discards it."""
    hi = jnp.maximum(x, y)
    lo = jnp.minimum(x, y)
    d = hi - lo
    return jnp.where(d >= _LOG_UNDERFLOW_THRESHOLD, hi, _lookup(d) + lo)


def log_add_exact(x, y):
    """Exact logaddexp (numerically stable)."""
    return jnp.logaddexp(x, y)


def logsumexp(a, axis=None, keepdims=False):
    return jax.nn.logsumexp(a, axis=axis, keepdims=keepdims)


# numpy reference versions (for host-side oracles / tests)

def np_lookup(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    idx = (x > _BREAKS[0]).astype(np.int64) + (x > _BREAKS[1]) + (x > _BREAKS[2])
    coeff = _CUBIC[idx]
    return ((coeff[..., 0] * x + coeff[..., 1]) * x + coeff[..., 2]) * x + coeff[..., 3]


def np_log_add_lut(x, y):
    """Scalar/array numpy twin of the reference logAdd (pairwiseAligner.c:295-299)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    hi = np.maximum(x, y)
    lo = np.minimum(x, y)
    with np.errstate(invalid="ignore"):
        d = hi - lo
    use_hi = np.isinf(lo) | np.isnan(d) | (d >= _LOG_UNDERFLOW_THRESHOLD)
    d_safe = np.where(use_hi, 0.0, d)
    out = np.where(use_hi, hi, np_lookup(d_safe) + lo)
    return out
