"""Banded pair-HMM forward-backward with posterior extraction.

Parity: getPosteriorProbsWithBanding (pairwiseAligner.c:706-844) +
diagonalCalculationPosteriorProbs (:637-681). The reference walks
anti-diagonals with linked DpDiagonals and periodic traceback to bound
memory; here the band is laid out as a dense (diagonal, band-offset) grid
with host-precomputed per-diagonal geometry, the forward pass is one
`lax.scan` storing all diagonals, and the backward pass re-reads them to
emit per-cell posterior probabilities for match/gapX/gapY states — the
same probabilities, computed with one global total.

Band geometry: cell k of diagonal d is xmy = xmyL[d] + 2k, with
x = (d+xmy)/2, y = (d-xmy)/2. Dependencies are index shifts between
adjacent diagonals' band offsets, precomputed on the host
(see `BandGeometry`).
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass

import numpy as np

from margin_tpu.utils.lazyjax import jax, jnp, lazy_jit

from margin_tpu.ops import logmath
from margin_tpu.ops.pairhmm import (GAPX, GAPY, LOG_ZERO, MATCH, PairHmmTables,
                                    _ensure_registered,
                                    T_EXT_X, T_EXT_Y, T_MM, T_M_FROM_GX,
                                    T_M_FROM_GY, T_OPEN_X, T_OPEN_Y, T_SW_X,
                                    T_SW_Y, _log_add3)
from margin_tpu.testing.oracle import build_band


@dataclass
class BandGeometry:
    """Host-side band description, padded to (D+1, W)."""
    lx: int
    ly: int
    d_pad: int          # padded diagonal count (>= lx+ly+1)
    w_pad: int          # padded band width
    xmy_l: np.ndarray   # (d_pad,) int32 storage base: cell k holds xmy_l+2k
    widths: np.ndarray  # (d_pad,) int32 exclusive upper valid k
    x_base: np.ndarray  # (d_pad,) x index of consumed char at k=0: (d+xmyL)/2 - 1
    y_base: np.ndarray  # (d_pad,) y index of consumed char at k=0: (d-xmyL)/2 - 1
    pm1: bool = False   # storage base moves by exactly +-1 per diagonal
    k_lo: np.ndarray | None = None  # (d_pad,) first valid k (None -> 0)

    @staticmethod
    def build(anchors, lx: int, ly: int, expansion: int,
              d_pad: int | None = None, w_pad: int | None = None,
              dynamic: bool = False, smooth: bool = False) -> "BandGeometry":
        band = build_band([] if anchors is None else anchors, lx, ly,
                          expansion, dynamic=dynamic)
        d_real = lx + ly + 1
        lo = band[:, 0].astype(np.int64)
        hi = band[:, 1].astype(np.int64)
        if smooth and d_real > 1:
            # Decouple the STORAGE track from the VALIDITY interval: the
            # storage base s must step by exactly +-1 per diagonal so the
            # kernel's inter-diagonal dependencies become static shifts
            # (`_shift_sel`) instead of W-wide dynamic gathers — the
            # dominant accelerator scan-step cost. s = the maximal
            # 1-Lipschitz minorant of the true band lower bound,
            # s[d] = min_d' (lo[d'] + |d-d'|): parity (xmy == d mod 2)
            # makes every unit-Lipschitz step exactly +-1. Valid cells keep
            # the EXACT reference band via [k_lo, widths) masking, so
            # results are bit-identical; only storage widens (w_pad grows
            # by half the largest band jump).
            d_r = np.arange(d_real)
            fwd_min = np.minimum.accumulate(lo - d_r) + d_r
            bwd_min = np.minimum.accumulate((lo + d_r)[::-1])[::-1] - d_r
            s = np.minimum(fwd_min, bwd_min)
            k_lo_real = (lo - s) // 2
            widths_real = ((hi - s) // 2 + 1).astype(np.int32)
            base = s
        else:
            k_lo_real = np.zeros(d_real, dtype=np.int64)
            widths_real = ((hi - lo) // 2 + 1).astype(np.int32)
            base = lo
        if d_pad is None:
            d_pad = d_real
        if w_pad is None:
            w_pad = int(widths_real.max())
        xmy_l = np.zeros(d_pad, dtype=np.int32)
        w = np.zeros(d_pad, dtype=np.int32)
        k_lo = np.zeros(d_pad, dtype=np.int32)
        xmy_l[:d_real] = base
        w[:d_real] = widths_real
        k_lo[:d_real] = k_lo_real
        d_idx = np.arange(d_pad, dtype=np.int64)
        x_base = ((d_idx + xmy_l) // 2 - 1).astype(np.int32)
        y_base = ((d_idx - xmy_l) // 2 - 1).astype(np.int32)
        steps = np.abs(np.diff(base)) if d_real > 1 else np.zeros(1)
        pm1 = bool(steps.max(initial=0) <= 1)
        return BandGeometry(lx, ly, d_pad, w_pad, xmy_l, w, x_base, y_base,
                            pm1, k_lo if k_lo.any() else None)

    def repad(self, d_pad: int, w_pad: int) -> "BandGeometry":
        """Re-pad an (unpadded or smaller-padded) geometry to a larger
        (d_pad, w_pad) without re-walking the anchors — identical to
        calling build() with the same flags and the bigger pads (padded
        diagonals carry xmy_l/width/k_lo == 0 and the derived bases)."""
        d_real = len(self.xmy_l)
        assert d_pad >= d_real and w_pad >= self.w_pad
        xmy_l = np.zeros(d_pad, dtype=np.int32)
        xmy_l[:d_real] = self.xmy_l
        w = np.zeros(d_pad, dtype=np.int32)
        w[:d_real] = self.widths
        k_lo = None
        if self.k_lo is not None:
            k_lo = np.zeros(d_pad, dtype=np.int32)
            k_lo[:d_real] = self.k_lo
        d_idx = np.arange(d_pad, dtype=np.int64)
        x_base = ((d_idx + xmy_l) // 2 - 1).astype(np.int32)
        y_base = ((d_idx - xmy_l) // 2 - 1).astype(np.int32)
        return BandGeometry(self.lx, self.ly, d_pad, w_pad, xmy_l, w,
                            x_base, y_base, self.pm1, k_lo)



def _bucket_dpad(n: int) -> int:
    """Pad diagonal counts to {2^k, 1.5*2^k} steps: bounded compile
    variants with at most ~33% padding waste (pow2 alone wastes up to 2x,
    which is real wall time in the scan-dominated FB)."""
    n = max(n, 64)
    p = 1 << (int(n - 1).bit_length())          # next pow2 >= n
    half = (p >> 1) + (p >> 2)                  # 1.5 * previous pow2
    return half if half >= n else p


def _gather_shift(arr, shift):
    """arr: (3, W). Returns arr indexed at k+shift along axis 1 with LOG_ZERO
    padding out of range."""
    w = arr.shape[-1]
    idx = jnp.arange(w) + shift
    valid = (idx >= 0) & (idx < w)
    vals = jnp.take(arr, jnp.clip(idx, 0, w - 1), axis=-1)
    return jnp.where(valid[None, :], vals, LOG_ZERO)


def _shift_sel(arr, shift):
    """arr shifted along the last axis by a traced `shift` KNOWN to be in
    {-1, 0, +1} (band bounds move by one cell per anti-diagonal). Builds
    the three statically-shifted variants and selects — elementwise work
    instead of a W-sized dynamic gather per scan step."""
    neg = jnp.asarray(LOG_ZERO, arr.dtype)
    left = jnp.concatenate(  # k+1
        [arr[..., 1:], jnp.full(arr.shape[:-1] + (1,), neg)], axis=-1)
    right = jnp.concatenate(  # k-1
        [jnp.full(arr.shape[:-1] + (1,), neg), arr[..., :-1]], axis=-1)
    return jnp.where(shift == 0, arr, jnp.where(shift > 0, left, right))


def _smooth_policy() -> bool:
    """Whether band geometry should use the smoothed (always-pm1) storage
    track. On accelerators the static shift replaces a dynamic gather per
    step and uniform pm1 keeps the batch groups from fragmenting; on CPU
    gathers are cheap and the wider storage is a net loss."""
    return jax.default_backend() != "cpu"


def _precompute_policy(b: int, d_pad: int, w_pad: int) -> bool:
    """Whether _banded_fb_core should hoist per-diagonal emissions out of
    the scans. On accelerators this leaves only shifts and log-adds in the
    loop body; hoisting costs ~10 (B, D, W) f32 buffers transiently, so
    gate on size. On the CPU backend the per-step gathers are cheap and
    the extra memory traffic is a net loss, so keep the in-scan path
    there."""
    if jax.default_backend() == "cpu":
        return False
    return b * d_pad * w_pad * 4 * 10 <= 4e9


@lazy_jit(static_argnames=("d_pad", "w_pad", "use_lut", "use_rle",
                                    "compute_expectations",
                                    "precompute_emissions", "pm1"))
def _banded_fb(tables_match, tables_gapx, tables_gapy, trans,
               x_sym, y_sym, lx, ly,
               xmy_l, widths, x_base, y_base,
               ragged_left, ragged_right,
               d_pad: int, w_pad: int, use_lut: bool,
               use_rle: bool = False, rep_table=None, rep_x=None, rep_y=None,
               compute_expectations: bool = False,
               precompute_emissions: bool = False,
               pm1: bool = False, k_lo=None):
    return _banded_fb_core(tables_match, tables_gapx, tables_gapy, trans,
                           x_sym, y_sym, lx, ly, xmy_l, widths, x_base,
                           y_base, ragged_left, ragged_right, d_pad, w_pad,
                           use_lut, use_rle, rep_table, rep_x, rep_y,
                           compute_expectations, precompute_emissions,
                           pm1, k_lo)


@lazy_jit(static_argnames=("d_pad", "w_pad", "use_lut", "use_rle",
                                    "precompute_emissions", "pm1"))
def _banded_fb_many(tables_match, tables_gapx, tables_gapy, trans,
                    x_sym, y_sym, lx, ly,
                    xmy_l, widths, x_base, y_base,
                    ragged_left, ragged_right,
                    d_pad: int, w_pad: int, use_lut: bool,
                    use_rle: bool = False, rep_table=None,
                    rep_x=None, rep_y=None,
                    precompute_emissions: bool = False,
                    pm1: bool = False, k_lo=None):
    """vmapped _banded_fb over a batch of same-padded-shape problems.
    Batched args: x_sym/y_sym (B, Lp), lx/ly (B,), geometry (B, D).
    Returns (post (B, D, 3, W), total (B,))."""
    if k_lo is None:
        k_lo = jnp.zeros_like(xmy_l)
    if use_rle:
        def one(xs, ys, lx1, ly1, xl, wd, xb, yb, kl, rx, ry):
            return _banded_fb_core(
                tables_match, tables_gapx, tables_gapy, trans,
                xs, ys, lx1, ly1, xl, wd, xb, yb,
                ragged_left, ragged_right, d_pad, w_pad, use_lut,
                use_rle=True, rep_table=rep_table, rep_x=rx, rep_y=ry,
                precompute_emissions=precompute_emissions, pm1=pm1,
                k_lo=kl)
        return jax.vmap(one)(x_sym, y_sym, lx, ly, xmy_l, widths,
                             x_base, y_base, k_lo, rep_x, rep_y)

    def one(xs, ys, lx1, ly1, xl, wd, xb, yb, kl):
        return _banded_fb_core(
            tables_match, tables_gapx, tables_gapy, trans,
            xs, ys, lx1, ly1, xl, wd, xb, yb,
            ragged_left, ragged_right, d_pad, w_pad, use_lut,
            precompute_emissions=precompute_emissions, pm1=pm1, k_lo=kl)
    return jax.vmap(one)(x_sym, y_sym, lx, ly, xmy_l, widths,
                         x_base, y_base, k_lo)


def _scan_unroll() -> int:
    """Unroll factor for the anti-diagonal scans. On accelerators the
    per-step work (a few (B, 3, W) elementwise ops) is far below the fixed
    per-iteration cost of a device loop step, so fusing steps amortizes
    it. On the CPU backend unrolling regressed (larger code, no per-step
    overhead to amortize), so keep it sequential there."""
    return 1 if jax.default_backend() == "cpu" else 8


def _banded_fb_core(tables_match, tables_gapx, tables_gapy, trans,
                    x_sym, y_sym, lx, ly,
                    xmy_l, widths, x_base, y_base,
                    ragged_left, ragged_right,
                    d_pad: int, w_pad: int, use_lut: bool,
                    use_rle: bool = False, rep_table=None, rep_x=None,
                    rep_y=None, compute_expectations: bool = False,
                    precompute_emissions: bool = False,
                    pm1: bool = False, k_lo=None):
    """Returns (post: (d_pad, 3, w_pad) probabilities, total log prob) —
    plus, with compute_expectations, a (3, 3) [from, to] transition
    expectation matrix (updateExpectations, pairwiseAligner.c:349-366).

    x_sym: (Lxp,) int32 padded with 4; y_sym likewise.
    """
    log_add = logmath.log_add_lut if use_lut else logmath.log_add_exact
    # pm1 (host-verified: every xmy_l step is +-1 across real diagonals)
    # means all inter-diagonal band shifts land in {-1, 0, +1}, so the
    # W-wide dynamic gathers in the scan bodies collapse to static
    # shift+select.
    # Padded diagonals beyond lx+ly violate the invariant but their cells
    # are masked invalid, so wrong shifts there never reach the output.
    shift_fn = _shift_sel if pm1 else _gather_shift
    W = w_pad
    D = d_pad
    if k_lo is None:
        k_lo = jnp.zeros_like(xmy_l)
    dtype = tables_match.dtype
    neg = jnp.asarray(LOG_ZERO, dtype)
    k_iota = jnp.arange(W)

    trc = {i: trans[i] for i in range(9)}

    xpad = jnp.concatenate([x_sym.astype(jnp.int32),
                            jnp.full((W + 1,), 4, jnp.int32)])
    ypad = jnp.concatenate([y_sym.astype(jnp.int32),
                            jnp.full((W + 1,), 4, jnp.int32)])
    # reversed y for the k-descending gather: yr[j] = ypad[Lyp-1-j]
    yr = jnp.flip(ypad)
    lyp = ypad.shape[0]

    if use_rle:
        rxpad = jnp.concatenate([rep_x.astype(jnp.int32),
                                 jnp.zeros((W + 1,), jnp.int32)])
        rypad = jnp.concatenate([rep_y.astype(jnp.int32),
                                 jnp.zeros((W + 1,), jnp.int32)])

    def _match_emission(cx, cy, cx_idx, cy_idx):
        e_m = jnp.take(tables_match, cx * 5 + cy)
        if use_rle:
            # RLE overlay (stateMachine.c:733-738): + 2.3025*repeat[base,
            # strand, observed=rep_y, underlying=rep_x]; table pre-scaled
            rx = jnp.where((cx_idx >= 0) & (cx_idx < lx),
                           jnp.take(rxpad, jnp.clip(cx_idx, 0, rxpad.shape[0] - 1)), 0)
            ry = jnp.where((cy_idx >= 0) & (cy_idx < ly),
                           jnp.take(rypad, jnp.clip(cy_idx, 0, rypad.shape[0] - 1)), 0)
            base = jnp.where(cx >= 4, 0, cx)
            n = 51
            e_m = e_m + jnp.take(rep_table, base * (n * n) + rx * n + ry)
        return e_m

    def consumed_syms(d):
        """Symbols consumed arriving at cell k of diag d: X[xb+k], Y[yb-k]."""
        xb = x_base[d]
        yb = y_base[d]
        cx_idx = xb + k_iota
        cx = jnp.where((cx_idx >= 0) & (cx_idx < lx),
                       jnp.take(xpad, jnp.clip(cx_idx, 0, xpad.shape[0] - 1)), 4)
        cy_idx = yb - k_iota
        cy = jnp.where((cy_idx >= 0) & (cy_idx < ly),
                       jnp.take(ypad, jnp.clip(cy_idx, 0, ypad.shape[0] - 1)), 4)
        return cx, cy, cx_idx, cy_idx

    def valid_mask(d):
        # cell coordinates: x = x_base+1+k, y = y_base+1-k
        x_pos = x_base[d] + 1 + k_iota
        y_pos = y_base[d] + 1 - k_iota
        return ((k_iota >= k_lo[d]) & (k_iota < widths[d])
                & (x_pos >= 0) & (x_pos <= lx)
                & (y_pos >= 0) & (y_pos <= ly) & (d <= lx + ly))

    # initial cell: start-state weights at diag 0, k=0 (stateMachine.c:521-530)
    init_cell = jnp.where(
        ragged_left,
        jnp.array([LOG_ZERO, 0.0, 0.0], dtype),
        jnp.array([0.0, LOG_ZERO, LOG_ZERO], dtype))
    diag0 = jnp.full((3, W), neg).at[:, 0].set(init_cell)

    def _emissions_all(xb_off, yb_off):
        """Vectorized consumed-symbol emissions for every diagonal at once:
        (D, W) e_m/e_gx/e_gy via a few large gathers; hoisting them out of
        the loop leaves only shifts and log-adds in the body."""
        cx_idx = (x_base + xb_off)[:, None] + k_iota[None, :]
        cx = jnp.where((cx_idx >= 0) & (cx_idx < lx),
                       jnp.take(xpad, jnp.clip(cx_idx, 0, xpad.shape[0] - 1)),
                       4)
        cy_idx = (y_base + yb_off)[:, None] - k_iota[None, :]
        cy = jnp.where((cy_idx >= 0) & (cy_idx < ly),
                       jnp.take(ypad, jnp.clip(cy_idx, 0, ypad.shape[0] - 1)),
                       4)
        e_m = _match_emission(cx, cy, cx_idx, cy_idx)
        return e_m, jnp.take(tables_gapx, cx), jnp.take(tables_gapy, cy)

    def _valid_mask_all():
        x_pos = x_base[:, None] + 1 + k_iota[None, :]
        y_pos = y_base[:, None] + 1 - k_iota[None, :]
        return ((k_iota[None, :] >= k_lo[:, None])
                & (k_iota[None, :] < widths[:, None]) & (x_pos >= 0)
                & (x_pos <= lx) & (y_pos >= 0) & (y_pos <= ly)
                & (jnp.arange(D)[:, None] <= lx + ly))

    def _fwd_body(prev1, prev2, d, e_m, e_gx, e_gy, vm):
        s1 = (xmy_l[d] - 1 - xmy_l[d - 1]) // 2
        s2 = (xmy_l[d] - xmy_l[d - 2]) // 2
        low = shift_fn(prev1, s1)        # (x-1, y)
        up = shift_fn(prev1, s1 + 1)     # (x, y-1)
        mid = shift_fn(prev2, s2)        # (x-1, y-1)
        new_gx = e_gx + _log_add3(low[MATCH] + trc[T_OPEN_X],
                                  low[GAPX] + trc[T_EXT_X],
                                  low[GAPY] + trc[T_SW_X], log_add)
        new_m = e_m + _log_add3(mid[MATCH] + trc[T_MM],
                                mid[GAPX] + trc[T_M_FROM_GX],
                                mid[GAPY] + trc[T_M_FROM_GY], log_add)
        new_gy = e_gy + _log_add3(up[MATCH] + trc[T_OPEN_Y],
                                  up[GAPY] + trc[T_EXT_Y],
                                  up[GAPX] + trc[T_SW_Y], log_add)
        cur = jnp.stack([new_m, new_gx, new_gy])
        cur = jnp.where(vm[None, :], cur, neg)
        return jnp.maximum(cur, neg)

    def fwd_step(carry, d):
        prev1, prev2 = carry
        cx, cy, cx_idx, cy_idx = consumed_syms(d)
        e_m = _match_emission(cx, cy, cx_idx, cy_idx)
        e_gx = jnp.take(tables_gapx, cx)
        e_gy = jnp.take(tables_gapy, cy)
        cur = _fwd_body(prev1, prev2, d, e_m, e_gx, e_gy, valid_mask(d))
        # store flattened (3*W,): keeps the size-3 state axis off the
        # minor dimension of the stacked buffer
        return (cur, prev1), cur.reshape(3 * W)

    def fwd_step_pre(carry, xs):
        d, e_m, e_gx, e_gy, vm = xs
        prev1, prev2 = carry
        cur = _fwd_body(prev1, prev2, d, e_m, e_gx, e_gy, vm)
        return (cur, prev1), cur.reshape(3 * W)

    if precompute_emissions:
        e_mF, e_gxF, e_gyF = _emissions_all(0, 0)
        vm_all = _valid_mask_all()
        (fl1, fl2), fwd = jax.lax.scan(
            fwd_step_pre, (diag0, jnp.full((3, W), neg)),
            (jnp.arange(1, D), e_mF[1:], e_gxF[1:], e_gyF[1:], vm_all[1:]))
    else:
        (fl1, fl2), fwd = jax.lax.scan(
            fwd_step, (diag0, jnp.full((3, W), neg)),
            jnp.arange(1, D), unroll=_scan_unroll())
    fwd = jnp.concatenate([diag0.reshape(1, 3 * W), fwd])  # (D, 3*W)

    # total probability at the final corner (lx, ly): diag lx+ly, k where
    # xmy == lx-ly -> k = (lx-ly-xmyL)/2
    end_w = jnp.where(
        ragged_right,
        jnp.stack([(trc[T_OPEN_X] + trc[T_OPEN_Y]) / 2.0, trc[T_EXT_X], trc[T_EXT_Y]]),
        jnp.stack([trc[T_MM], trc[T_M_FROM_GX], trc[T_M_FROM_GY]]))
    d_final = lx + ly
    k_final = (lx - ly - xmy_l[d_final]) // 2
    f_final = jax.lax.dynamic_index_in_dim(
        jax.lax.dynamic_index_in_dim(fwd, d_final, 0,
                                     keepdims=False).reshape(3, W),
        k_final, axis=-1, keepdims=False)  # (3,)
    tot_terms = f_final + end_w
    total = log_add(log_add(tot_terms[0], tot_terms[1]), tot_terms[2])

    # backward pass over the stored forward diagonals, emitting posteriors
    bwd_final = jnp.full((3, W), neg).at[:, k_final].set(end_w)

    # transition log-prob matrix [from, to] for the expectation pass
    tmat = jnp.stack([
        jnp.stack([trc[T_MM], trc[T_OPEN_X], trc[T_OPEN_Y]]),
        jnp.stack([trc[T_M_FROM_GX], trc[T_EXT_X], trc[T_SW_Y]]),
        jnp.stack([trc[T_M_FROM_GY], trc[T_SW_X], trc[T_EXT_Y]]),
    ])

    def _bwd_body(next1, next2, exp_acc, d, e_m, e_gx, e_gy, vm):
        t1 = (xmy_l[d] + 1 - xmy_l[d + 1]) // 2
        t2 = (xmy_l[d] - xmy_l[d + 2]) // 2
        gx_n = shift_fn(next1, t1)[GAPX]       # (x+1, y)
        gy_n = shift_fn(next1, t1 - 1)[GAPY]   # (x, y+1)
        m_n = shift_fn(next2, t2)[MATCH]       # (x+1, y+1)
        b_m = _log_add3(gx_n + e_gx + trc[T_OPEN_X],
                        m_n + e_m + trc[T_MM],
                        gy_n + e_gy + trc[T_OPEN_Y], log_add)
        b_gx = _log_add3(gx_n + e_gx + trc[T_EXT_X],
                         m_n + e_m + trc[T_M_FROM_GX],
                         gy_n + e_gy + trc[T_SW_Y], log_add)
        b_gy = _log_add3(gx_n + e_gx + trc[T_SW_X],
                         m_n + e_m + trc[T_M_FROM_GY],
                         gy_n + e_gy + trc[T_EXT_Y], log_add)
        computed = jnp.maximum(
            jnp.where(vm[None, :], jnp.stack([b_m, b_gx, b_gy]),
                      neg), neg)
        cur = jnp.where(d == d_final, bwd_final, computed)
        f_d = jax.lax.dynamic_index_in_dim(
            fwd, d, 0, keepdims=False).reshape(3, W)
        post = jnp.exp(jnp.minimum(f_d + cur - total, 0.0))
        post = jnp.where(vm[None, :], post, 0.0)

        if compute_expectations:
            # updateExpectations (pairwiseAligner.c:349-366): posterior of
            # each (from cell at diag d) -> (to cell at diag d+1/d+2)
            # transition: exp(f[from] + b_next[to] + eP + tP - total)
            to_terms = jnp.stack([m_n + e_m, gx_n + e_gx, gy_n + e_gy])
            contrib = jnp.exp(f_d[:, None, :] + to_terms[None, :, :]
                              + tmat[:, :, None] - total)
            contrib = jnp.where(vm[None, None, :], contrib, 0.0)
            exp_acc = exp_acc + contrib.sum(axis=-1)

        return (cur, next1, exp_acc), post.reshape(3 * W)

    def bwd_step(carry, d):
        next1, next2, exp_acc = carry  # bwd at diagonals d+1, d+2
        # symbols consumed LEAVING cell k of diag d:
        # to gapX consumes X[x], to match consumes X[x], Y[y]
        xb = x_base[d] + 1
        yb = y_base[d]
        cx_idx = xb + k_iota
        cx = jnp.where((cx_idx >= 0) & (cx_idx < lx),
                       jnp.take(xpad, jnp.clip(cx_idx, 0, xpad.shape[0] - 1)),
                       4)
        cy_idx = yb + 1 - k_iota
        cy = jnp.where((cy_idx >= 0) & (cy_idx < ly),
                       jnp.take(ypad, jnp.clip(cy_idx, 0, ypad.shape[0] - 1)),
                       4)
        e_m = _match_emission(cx, cy, cx_idx, cy_idx)
        e_gx = jnp.take(tables_gapx, cx)
        e_gy = jnp.take(tables_gapy, cy)
        return _bwd_body(next1, next2, exp_acc, d, e_m, e_gx, e_gy,
                         valid_mask(d))

    def bwd_step_pre(carry, xs):
        d, e_m, e_gx, e_gy, vm = xs
        next1, next2, exp_acc = carry
        return _bwd_body(next1, next2, exp_acc, d, e_m, e_gx, e_gy, vm)

    bwd_init = (jnp.full((3, W), neg), jnp.full((3, W), neg),
                jnp.zeros((3, 3), dtype))
    if precompute_emissions:
        e_mB, e_gxB, e_gyB = _emissions_all(1, 1)
        (_, _, exp_acc), post = jax.lax.scan(
            bwd_step_pre, bwd_init,
            (jnp.arange(D - 1, -1, -1), jnp.flip(e_mB, 0),
             jnp.flip(e_gxB, 0), jnp.flip(e_gyB, 0), jnp.flip(vm_all, 0)))
    else:
        (_, _, exp_acc), post = jax.lax.scan(
            bwd_step, bwd_init,
            jnp.arange(D - 1, -1, -1), unroll=_scan_unroll())
    # ascending diagonal order, (D, 3, W)
    post = jnp.flip(post, axis=0).reshape(D, 3, W)
    if compute_expectations:
        return post, total, exp_acc
    return post, total


def get_split_points(anchors, lx: int, ly: int, split_bigger_than: int,
                     ragged_left: bool, ragged_right: bool):
    """getSplitPoints (pairwiseAligner.c:913-966): split the DP into
    sub-rectangles around anchor gaps whose area exceeds
    splitMatrixBiggerThanThis. Returns [(x1, y1, x2, y2)]."""
    import math
    out = []
    state = [0, 0]  # current region origin (x1, y1)

    def split_p(x2, y2, x3, y3, skip_block):
        lx2, ly2 = x3 - x2, y3 - y2
        if lx2 * ly2 > split_bigger_than:
            max_len = int(math.sqrt(split_bigger_than))
            hx = max_len if lx2 // 2 > max_len else lx2 // 2
            hy = max_len if ly2 // 2 > max_len else ly2 // 2
            if not skip_block:
                out.append((state[0], state[1], x2 + hx, y2 + hy))
            state[0] = x3 - hx
            state[1] = y3 - hy
            return True
        return False

    x2 = y2 = 0
    for i, a in enumerate(anchors):
        x3, y3 = int(a[0]), int(a[1])
        split_p(x2, y2, x3, y3, ragged_left and i == 0)
        x2, y2 = x3 + 1, y3 + 1
    if (not split_p(x2, y2, lx, ly, ragged_left and len(anchors) == 0)
            or not ragged_right):
        out.append((state[0], state[1], lx, ly))
    return out


def banded_posteriors_split(tables: PairHmmTables, x_sym, y_sym, anchors,
                            expansion: int, strand: int,
                            split_bigger_than: int,
                            ragged_left=False, ragged_right=False,
                            threshold: float = 0.01, use_lut: bool = False,
                            dynamic: bool = False, rep_x=None, rep_y=None):
    """getPosteriorProbsWithBandingSplittingAlignmentsByLargeGaps
    (pairwiseAligner.c:984-1040): run banded_posteriors per sub-rectangle
    and merge pair lists with coordinate correction. Returns the same
    ((matches, gapx, gapy), total-sum) shape as banded_posteriors."""
    _ensure_registered()
    lx, ly = len(x_sym), len(y_sym)
    anchors = [] if anchors is None else [tuple(int(v) for v in a)
                                          for a in anchors]
    splits = get_split_points(anchors, lx, ly, split_bigger_than,
                              bool(ragged_left), bool(ragged_right))
    if len(splits) == 1 and splits[0] == (0, 0, lx, ly):
        return banded_posteriors(tables, x_sym, y_sym, anchors, expansion,
                                 strand, ragged_left, ragged_right,
                                 threshold, use_lut, dynamic=dynamic,
                                 rep_x=rep_x, rep_y=rep_y)
    out_m, out_gx, out_gy = [], [], []
    total = 0.0
    j = 0
    for i, (x1, y1, x2, y2) in enumerate(splits):
        sub_anchors = []
        while j < len(anchors):
            x, y = anchors[j][0], anchors[j][1]
            if x + y >= x2 + y2:
                break
            sub_anchors.append((x - x1, y - y1) + tuple(anchors[j][2:]))
            j += 1
        (m, gx, gy), t = banded_posteriors(
            tables, x_sym[x1:x2], y_sym[y1:y2], sub_anchors, expansion,
            strand,
            ragged_left=(ragged_left or i > 0),
            ragged_right=(ragged_right or i < len(splits) - 1),
            threshold=threshold, use_lut=use_lut, dynamic=dynamic,
            rep_x=rep_x[x1:x2] if rep_x is not None else None,
            rep_y=rep_y[y1:y2] if rep_y is not None else None)
        for arr, acc in ((m, out_m), (gx, out_gx), (gy, out_gy)):
            if len(arr):
                arr = arr.copy()
                arr[:, 1] += x1
                arr[:, 2] += y1
            acc.append(arr)
        total += t
    empty = np.zeros((0, 3), dtype=np.int64)
    cat = lambda lst: np.concatenate(lst) if lst else empty
    return (cat(out_m), cat(out_gx), cat(out_gy)), total


@lazy_jit(static_argnames=("K",))
def _device_extract(post, x_base, y_base, threshold, K: int):
    """Device-side addPosteriorProb thresholding: compact the (D, 3, W)
    posterior grid into per-state (prob, x-1, y-1) candidate arrays of
    static size K (valid-count returned; overflow detected by count > K).
    Avoids transferring the full grid to the host."""
    W = post.shape[-1]
    k_iota = jnp.arange(W)[None, :]
    x_pos = x_base[:, None] + 1 + k_iota      # (D, W) cell coordinates
    y_pos = y_base[:, None] + 1 - k_iota
    vals, xs, ys, counts = [], [], [], []
    for state, need_x, need_y in ((MATCH, True, True), (GAPX, True, False),
                                  (GAPY, False, True)):
        grid = post[:, state, :]
        sel = grid >= threshold
        if need_x:
            sel = sel & (x_pos > 0)
        if need_y:
            sel = sel & (y_pos > 0)
        counts.append(jnp.sum(sel))
        d_i, k_i = jnp.nonzero(sel, size=K, fill_value=0)
        # int32 is enough for PAIR_ALIGNMENT_PROB_1-scaled probs and
        # avoids the x64-disabled truncation warning
        probs = jnp.floor(jnp.minimum(grid[d_i, k_i], 1.0)
                          * 10_000_000).astype(jnp.int32)
        valid = jnp.arange(K) < counts[-1]
        vals.append(jnp.where(valid, probs, 0))
        xs.append(jnp.where(valid, x_pos[d_i, k_i] - 1, 0))
        ys.append(jnp.where(valid, y_pos[d_i, k_i] - 1, 0))
    return (jnp.stack(vals), jnp.stack(xs), jnp.stack(ys),
            jnp.stack(counts))


@lazy_jit(static_argnames=("K",))
def _device_extract_many(post, x_base, y_base, threshold, K: int):
    """vmapped _device_extract over a batch: post (B, D, 3, W)."""
    return jax.vmap(lambda p, xb, yb: _device_extract(p, xb, yb, threshold,
                                                      K))(post, x_base, y_base)


def _pairs_from_compact(vals, xs, ys, counts, K: int, post, geom, threshold):
    """Assemble per-state pair arrays from the compacted device extraction;
    falls back to the full-grid host path if a state overflowed K."""
    if int(counts.max()) > K:
        return extract_pairs_from_grid(np.asarray(post), geom, threshold)
    out = []
    for s in range(3):
        c = int(counts[s])
        pairs = np.stack([vals[s, :c], xs[s, :c], ys[s, :c]],
                         axis=1).astype(np.int64)
        order = np.lexsort((pairs[:, 2], pairs[:, 1]))
        out.append(pairs[order])
    return tuple(out)


# running pairs-per-diagonal average per w_pad bucket: sizes the
# single-phase flat extraction's K guess (overflow retried exactly)
_FLAT_PAIRS_HINT: dict = {}


def _extract_cap(d_pad: int) -> int:
    # pairs >= 1% threshold cluster near the alignment path: a handful per
    # diagonal at most; 2*D is a generous static cap with overflow fallback
    return 2 * d_pad




def banded_posteriors(tables: PairHmmTables, x_sym: np.ndarray, y_sym: np.ndarray,
                      anchors, expansion: int, strand: int,
                      ragged_left=False, ragged_right=False,
                      threshold: float = 0.01, use_lut: bool = False,
                      pad_shapes: bool = True, dynamic: bool = False,
                      rep_x: np.ndarray | None = None,
                      rep_y: np.ndarray | None = None):
    """Compute (matches, gapx_pairs, gapy_pairs, total) like
    getAlignedPairsWithIndelsUsingAnchors (pairwiseAligner.c:1144-1171):
    lists of (prob_int, x, y) with prob scaled by PAIR_ALIGNMENT_PROB_1
    and >= threshold. gapX pairs are reference-consuming (deletes in the
    POA's frame); gapY are read-consuming (inserts)."""
    _ensure_registered()
    lx, ly = len(x_sym), len(y_sym)
    if lx + ly == 0:
        empty = np.zeros((0, 3), dtype=np.int64)
        return (empty, empty, empty), 0.0
    smooth = _smooth_policy()
    geom = BandGeometry.build(anchors, lx, ly, expansion, dynamic=dynamic,
                              smooth=smooth)
    d_pad = geom.d_pad
    w_pad = geom.w_pad
    if pad_shapes:  # stabilize compiled shapes
        d_pad = _bucket_dpad(d_pad)
        w_pad = int(np.ceil(w_pad / 8)) * 8
        geom = BandGeometry.build(anchors, lx, ly, expansion, d_pad, w_pad,
                                  dynamic=dynamic, smooth=smooth)

    # pad sequences to the padded diag count (so xpad indexing stays in range)
    xs = np.full(d_pad, 4, dtype=np.int32)
    xs[:lx] = x_sym
    ys = np.full(d_pad, 4, dtype=np.int32)
    ys[:ly] = y_sym

    use_rle = (rep_x is not None and tables.repeat is not None)
    rep_kwargs = {}
    if use_rle:
        rx = np.zeros(d_pad, dtype=np.int32)
        rx[:lx] = np.minimum(rep_x, 50)
        ry = np.zeros(d_pad, dtype=np.int32)
        ry[:ly] = np.minimum(rep_y, 50)
        rep_kwargs = dict(rep_table=tables.repeat[strand],
                          rep_x=jnp.asarray(rx), rep_y=jnp.asarray(ry))

    xb = jnp.asarray(geom.x_base)
    yb = jnp.asarray(geom.y_base)
    post, total = _banded_fb(
        tables.match[strand], tables.gap_x[strand], tables.gap_y[strand],
        tables.trans[strand],
        jnp.asarray(xs), jnp.asarray(ys), lx, ly,
        jnp.asarray(geom.xmy_l), jnp.asarray(geom.widths),
        xb, yb,
        bool(ragged_left), bool(ragged_right),
        d_pad=d_pad, w_pad=w_pad, use_lut=use_lut, use_rle=use_rle,
        precompute_emissions=_precompute_policy(1, d_pad, w_pad),
        pm1=geom.pm1,
        k_lo=None if geom.k_lo is None else jnp.asarray(geom.k_lo),
        **rep_kwargs)
    K = _extract_cap(d_pad)
    vals, pxs, pys, counts = _device_extract(post, xb, yb, threshold, K)
    pairs = _pairs_from_compact(np.asarray(vals), np.asarray(pxs),
                                np.asarray(pys), np.asarray(counts), K,
                                post, geom, threshold)
    return pairs, float(total)

class _FbItemRef:
    """One banded problem bound to its result slot. `out[idx]` receives the
    ((matches, gapx, gapy), total) tuple; `req` (funnel requests only) is
    decremented so the issuing thread unblocks when all its items land.
    `geom` caches the classify-time band geometry."""
    __slots__ = ("item", "out", "idx", "req", "geom")

    def __init__(self, item, out, idx, req=None):
        self.item = item
        self.out = out
        self.idx = idx
        self.req = req
        self.geom = None


def use_device_fb() -> bool:
    """Whether batched solves run the Triton kernel (ops.banded_triton):
    on the GPU backend. Elsewhere the vmapped lax.scan runs."""
    return jax.default_backend() == "gpu"


# forward-store cells one pack may hold when the device reports no memory
# limit (the CPU backend, where packs run in interpret mode)
_PACK_CELLS_DEFAULT = 1 << 24


def pack_cell_budget() -> int:
    """Forward-store cells (float32) of one pack. Two packs are in flight
    and the extraction's mask and prefix sum add about 1.25x the store,
    so a pack takes at most 1/16 of the device's memory limit. The flat
    cell index must also stay below 2^31 (int32 offsets)."""
    try:
        limit = jax.devices()[0].memory_stats()["bytes_limit"]
    except Exception:
        return _PACK_CELLS_DEFAULT
    return int(min(1 << 30, limit // 16))


class _PackHandle:
    """An in-flight pack: FB + extraction dispatched, readback deferred."""
    __slots__ = ("refs", "pack", "packed", "K", "use_rle", "t_launch")


def _launch_pack(tables, refs, w_pad: int, use_rle: bool, use_lut: bool,
                 threshold: float, interpret: bool) -> _PackHandle:
    """Pack the host arrays and dispatch the FB and extraction WITHOUT
    reading anything back, so the host prepares the next pack while the
    card runs this one."""
    from margin_tpu.ops import banded_triton

    t0 = time.perf_counter()
    pack = banded_triton.build_pack(tables, [r.item for r in refs],
                                    [r.geom for r in refs], w_pad, use_rle)
    # single-phase extraction: K from the running pairs-per-diagonal
    # average (pairs >= threshold cluster near the alignment path); an
    # overflow re-launches with the exact count
    ppd = _FLAT_PAIRS_HINT.get(w_pad, 2.0)
    K = banded_triton.k_for(1.5 * ppd * pack.sum_d)
    h = _PackHandle()
    h.refs, h.pack, h.K, h.use_rle = refs, pack, K, use_rle
    h.packed = banded_triton.launch(tables, pack, use_lut, use_rle,
                                    threshold, K, interpret)
    h.t_launch = time.perf_counter() - t0
    return h


def _finish_pack(h: _PackHandle, tables, use_lut: bool, threshold: float,
                 interpret: bool):
    """Read back one pack (the synchronization point), decode, store."""
    from margin_tpu.ops import banded_triton
    from margin_tpu.parallel.executor import DEVICE_STATS

    t0 = time.perf_counter()
    arr = np.asarray(h.packed)
    t1 = time.perf_counter()
    res = banded_triton.unpack(h.pack, arr, h.K)
    if res is None:  # rare: the guess was too small
        K2 = banded_triton.k_for(int(arr[0]))
        arr = np.asarray(banded_triton.launch(tables, h.pack, use_lut,
                                              h.use_rle, threshold, K2,
                                              interpret))
        res = banded_triton.unpack(h.pack, arr, K2)
    count = int(arr[0])
    ppd = _FLAT_PAIRS_HINT.get(h.pack.w_pad, 2.0)
    _FLAT_PAIRS_HINT[h.pack.w_pad] = (0.5 * ppd
                                      + 0.5 * count / max(h.pack.sum_d, 1))
    DEVICE_STATS.add(len(h.refs), h.pack.used, t1 - t0)
    for ref, r in zip(h.refs, res):
        ref.out[ref.idx] = r


# shared pool for items routed to the native C++ kernel: it drops the GIL,
# so these overlap the device pack launches
_FB_FALLBACK_POOL = None


def _fallback_pool():
    global _FB_FALLBACK_POOL
    if _FB_FALLBACK_POOL is None:
        from concurrent.futures import ThreadPoolExecutor
        _FB_FALLBACK_POOL = ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="fb-fallback")
    return _FB_FALLBACK_POOL


def device_eligible(geom: BandGeometry, budget: int) -> bool:
    """Whether one problem runs on the device kernel: its band fits the
    widest kernel (128) and its diagonals alone fit a pack. Everything
    else solves on the native C++ kernel (native/marginfb.cc)."""
    from margin_tpu.ops import banded_triton
    if geom.w_pad > banded_triton.WIDTHS[-1]:
        return False
    w = banded_triton.bucket_w(geom.w_pad)
    return banded_triton.pack_cells([geom], w) <= budget


class _DeviceRun:
    """Pipelined pack scheduler over a stream of classified items.

    Items are bucketed by (band width bucket, use_rle); packs are the
    deepest-first prefix of a bucket that fits the cell budget, launched
    with depth-2 pipelining (pack k+1 is packed and dispatched before pack
    k's readback). An optional `refill` hook absorbs newly queued items
    between packs so concurrent chunk threads' problems share launches
    (the cross-chunk funnel). complete_cb fires once per stored ref."""

    def __init__(self, tables, expansion: int, threshold: float,
                 use_lut: bool, dynamic: bool, complete_cb=None,
                 interpret: bool = False):
        self.tables = tables
        self.expansion = expansion
        self.threshold = threshold
        self.use_lut = use_lut
        self.dynamic = dynamic
        self.complete_cb = complete_cb
        self.interpret = interpret
        self.budget = pack_cell_budget()
        self.buckets: dict = {}     # (w_pad, use_rle) -> [(depth, ref)]
        self.fallback: list = []    # refs for the native side pool
        self.fb_futures: list = []  # (future, [refs])
        self.n_native = 0

    def add(self, refs):
        from margin_tpu.ops import banded_triton
        for ref in refs:
            it = ref.item
            lx, ly = len(it["x_sym"]), len(it["y_sym"])
            if lx + ly == 0:
                empty = np.zeros((0, 3), dtype=np.int64)
                self._store(ref, ((empty, empty, empty), 0.0))
                continue
            geom = _item_geom(it, self.expansion, self.dynamic)
            ref.geom = geom
            if not device_eligible(geom, self.budget):
                self.fallback.append(ref)
                continue
            use_rle = (it.get("rep_x") is not None
                       and self.tables.repeat is not None)
            key = (banded_triton.bucket_w(geom.w_pad), use_rle)
            self.buckets.setdefault(key, []).append((lx + ly, ref))

    def _store(self, ref, result):
        ref.out[ref.idx] = result
        if self.complete_cb is not None:
            self.complete_cb(ref)

    def _flush_fallback(self):
        if not self.fallback:
            return
        refs, self.fallback = self.fallback, []
        self.n_native += len(refs)
        fut = _fallback_pool().submit(
            _solve_native_items, self.tables, [r.item for r in refs],
            self.expansion, self.threshold, self.use_lut, self.dynamic)
        self.fb_futures.append((fut, refs))

    def _next_pack(self):
        """The deepest-first prefix of the fullest bucket that fits the
        cell budget (always at least one problem: device_eligible)."""
        from margin_tpu.ops import banded_triton
        key = max(self.buckets, key=lambda k: len(self.buckets[k]))
        lst = sorted(self.buckets.pop(key), key=lambda t: -t[0])
        w_pad = key[0]
        n = 1
        lo, hi = 1, len(lst)
        while lo <= hi:  # largest prefix within the budget
            mid = (lo + hi) // 2
            if banded_triton.pack_cells([r.geom for _, r in lst[:mid]],
                                        w_pad) <= self.budget:
                n, lo = mid, mid + 1
            else:
                hi = mid - 1
        if lst[n:]:
            self.buckets[key] = lst[n:]
        return key, [r for _, r in lst[:n]]

    def drain(self, refill=None):
        """Launch until no work remains; `refill()` may return more refs to
        absorb between packs. Host packing (this thread) pipelines against
        readback and unpacking (a finisher thread) through a bounded queue,
        which also caps device memory at two packs in flight."""
        import queue as _queue

        self._flush_fallback()
        finish_q: _queue.Queue = _queue.Queue(maxsize=2)
        errors: list = []

        def finisher():
            while True:
                h = finish_q.get()
                if h is None:
                    finish_q.task_done()
                    return
                try:
                    _finish_pack(h, self.tables, self.use_lut,
                                 self.threshold, self.interpret)
                    if self.complete_cb is not None:
                        for ref in h.refs:
                            self.complete_cb(ref)
                except BaseException as e:
                    errors.append(e)
                finally:
                    finish_q.task_done()

        fin = threading.Thread(target=finisher, daemon=True,
                               name="fb-finisher")
        fin.start()
        try:
            while not errors:
                if refill is not None:
                    self.add(refill())
                    self._flush_fallback()
                if not self.buckets:
                    finish_q.join()  # let in-flight packs land
                    if refill is not None:
                        # one more look: items may have queued during the
                        # last pack's flight
                        self.add(refill())
                        self._flush_fallback()
                        if self.buckets:
                            continue
                    break
                (w_pad, use_rle), refs = self._next_pack()
                h = _launch_pack(self.tables, refs, w_pad, use_rle,
                                 self.use_lut, self.threshold,
                                 self.interpret)
                finish_q.put(h)  # blocks at 2 in flight
        finally:
            finish_q.put(None)
            fin.join()
        if errors:
            raise errors[0]
        for fut, refs in self.fb_futures:
            for ref, r in zip(refs, fut.result()):
                self._store(ref, r)
        self.fb_futures = []


def posteriors_many_device(tables: PairHmmTables, items, expansion: int,
                           threshold: float, use_lut: bool, dynamic: bool,
                           interpret: bool = False):
    """Batched solve on the Triton kernel without the cross-chunk funnel
    (`interpret=True` runs the kernels on the CPU). Returns
    (results, number of items routed to the native kernel)."""
    results = [None] * len(items)
    run = _DeviceRun(tables, expansion, threshold, use_lut, dynamic,
                     interpret=interpret)
    run.add([_FbItemRef(it, results, i) for i, it in enumerate(items)])
    run.drain()
    return results, run.n_native


class _FbRequest:
    __slots__ = ("items", "results", "remaining", "done", "error")

    def __init__(self, items):
        self.items = items
        self.results = [None] * len(items)
        self.remaining = len(items)
        self.done = False
        self.error = None


class _FbFunnel:
    """Cross-chunk combining funnel for batched banded-FB solves.

    The polish driver runs chunks on host threads (polish.c:475-478); each
    chunk's poa_realign issues a banded_posteriors_many against the card.
    This funnel merges concurrent compatible calls: the thread that finds
    the device free becomes the dispatcher, runs a _DeviceRun whose refill
    hook keeps absorbing newly queued requests between packs, and releases
    each waiter as soon as all its items complete. Per-item results are
    identical to direct calls: programs never read across problems.
    `n_native` counts the items routed to the native kernel."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: list = []  # (key, request)
        self._busy = False
        self.n_native = 0

    def solve(self, tables, items, expansion, threshold, use_lut, dynamic):
        if not items:
            return []
        key = (id(tables), expansion, threshold, use_lut, dynamic)
        req = _FbRequest(list(items))
        with self._cond:
            self._queue.append((key, req))
            while not req.done:
                if self._busy:
                    self._cond.wait()
                    continue
                self._busy = True
                self._cond.release()
                try:
                    self._dispatch(tables, key, expansion, threshold,
                                   use_lut, dynamic)
                finally:
                    self._cond.acquire()
                    self._busy = False
                    self._cond.notify_all()
        if req.error is not None:
            raise req.error
        return req.results

    def _drain(self, key):
        """Pop every queued compatible request; returns their item refs."""
        with self._cond:
            mine = [r for k, r in self._queue if k == key]
            if mine:
                self._queue = [(k, r) for k, r in self._queue if k != key]
        refs = []
        for req in mine:
            refs.extend(_FbItemRef(it, req.results, i, req)
                        for i, it in enumerate(req.items))
        return refs

    def _complete(self, ref):
        req = ref.req
        if req is None:
            return
        with self._cond:
            req.remaining -= 1
            if req.remaining == 0 and not req.done:
                req.done = True
                self._cond.notify_all()

    def _dispatch(self, tables, key, expansion, threshold, use_lut, dynamic):
        run = _DeviceRun(tables, expansion, threshold, use_lut, dynamic,
                         complete_cb=self._complete)
        seen: list = []

        def refill():
            refs = self._drain(key)
            seen.extend(refs)
            return refs

        try:
            run.drain(refill=refill)
        except BaseException as e:  # surface on every waiter, avoid hangs
            with self._cond:
                for ref in seen:
                    if ref.req is not None and not ref.req.done:
                        ref.req.error = e
                        ref.req.done = True
                self._cond.notify_all()
            raise
        finally:
            self.n_native += run.n_native


_FB_FUNNEL = _FbFunnel()


def split_sub_items(item, split_bigger_than: int):
    """Segment one problem at large anchor gaps into ragged sub-items
    (getPosteriorProbsWithBandingSplittingAlignmentsByLargeGaps,
    pairwiseAligner.c:984-1040) so long-gap reads ride the batched solver
    with everything else. Returns (sub_items, (x1, y1) offsets)."""
    x_sym, y_sym = item["x_sym"], item["y_sym"]
    anchors = [] if item["anchors"] is None else \
        [tuple(int(v) for v in a) for a in item["anchors"]]
    lx, ly = len(x_sym), len(y_sym)
    splits = get_split_points(anchors, lx, ly, split_bigger_than,
                              False, False)
    subs, offs = [], []
    j = 0
    for i, (x1, y1, x2, y2) in enumerate(splits):
        sub_anchors = []
        while j < len(anchors):
            x, y = anchors[j][0], anchors[j][1]
            if x + y >= x2 + y2:
                break
            sub_anchors.append((x - x1, y - y1) + tuple(anchors[j][2:]))
            j += 1
        sub = {"x_sym": x_sym[x1:x2], "y_sym": y_sym[y1:y2],
               "anchors": sub_anchors, "strand": item["strand"],
               "ragged_left": i > 0, "ragged_right": i < len(splits) - 1}
        if item.get("rep_x") is not None:
            sub["rep_x"] = item["rep_x"][x1:x2]
            sub["rep_y"] = item["rep_y"][y1:y2]
        subs.append(sub)
        offs.append((x1, y1))
    return subs, offs


# items whose exact band exceeds this many cells route to the native C++
# kernel (native/marginfb.cc) on the scan path of every backend
_MONSTER_CELLS = 30_000_000


# on the CPU backend, mid-size bands above this route to the native
# kernel by default: the native FB is much faster per cell than the
# jax-CPU scan, with the same pair sets (tests/test_native_fb.py)
_NATIVE_SCAN_CELLS_CPU = 50_000


def _native_scan_cells() -> int:
    """Scan-path native-routing threshold. MARGIN_TPU_NATIVE_SCAN_CELLS
    overrides; otherwise CPU-backend processes use the low mid-size
    threshold and accelerator backends the monster-only policy."""
    v = os.environ.get("MARGIN_TPU_NATIVE_SCAN_CELLS")
    if v:
        return int(v)
    if jax.default_backend() == "cpu":
        return _NATIVE_SCAN_CELLS_CPU
    return _MONSTER_CELLS


def _true_band_cells(geom: BandGeometry) -> int:
    """Exact band cell count (independent of storage smoothing)."""
    w = geom.widths.astype(np.int64)
    if geom.k_lo is not None:
        w = w - geom.k_lo
    return int(np.maximum(w, 0).sum())


def _item_geom(it: dict, expansion: int, dynamic: bool) -> BandGeometry:
    """Smoothed (unpadded) band geometry for one item, cached on the item
    dict: the routing pass, the worker split and _DeviceRun.add all need
    the same geometry — build it once. The `_geom` key never crosses IPC
    (ScoreClient.banded whitelists wire keys)."""
    geom = it.get("_geom")
    if geom is None:
        geom = BandGeometry.build(it["anchors"], len(it["x_sym"]),
                                  len(it["y_sym"]), expansion,
                                  dynamic=dynamic, smooth=True)
        it["_geom"] = geom
    return geom


def _solve_native_items(tables, items, expansion, threshold, use_lut,
                        dynamic):
    """Native C++ banded FB over a list of items, threaded (the GIL drops
    for each call)."""
    from concurrent.futures import ThreadPoolExecutor

    from margin_tpu.ops import native_fb

    def one(i):
        return i, native_fb.posteriors_item(tables, items[i], expansion,
                                            threshold, use_lut, dynamic)

    results = [None] * len(items)
    n_threads = int(os.environ.get("MARGIN_TPU_NATIVE_FB_THREADS", "4"))
    with ThreadPoolExecutor(max_workers=max(1, min(n_threads,
                                                   len(items)))) as ex:
        for i, r in ex.map(one, range(len(items))):
            results[i] = r
    return results


def banded_posteriors_many(tables: PairHmmTables, items,
                           expansion: int, threshold: float = 0.01,
                           use_lut: bool = False, dynamic: bool = False):
    """Batched banded_posteriors: `items` is a list of dicts with keys
    x_sym, y_sym, anchors, strand, and optional rep_x/rep_y. Returns a list
    of ((matches, gapx, gapy), total) in input order.

    Backend routing: on the GPU the items ride the cross-chunk funnel onto
    the Triton kernel (ops.banded_triton), except bands wider than its 128
    lanes, which solve on the native C++ FB kernel (native/marginfb.cc).
    On the CPU backend items above ~50K exact band cells route to the
    native kernel and the rest take the lax.scan path —
    tests/test_native_fb.py asserts the two agree on the covered sizes.
    Per-item banded_posteriors always uses the scan path."""
    from margin_tpu.parallel import executor
    if (executor.has_ipc_client() and len(items) > 0
            and os.environ.get("MARGIN_TPU_IPC_BANDED", "1") != "0"):
        # worker process: the batch rides the socket to the device-owning
        # parent, whose funnel merges ALL workers' concurrent batches (the
        # worker stays jax-free: this check runs before any pytree
        # registration). Bands too wide for the device kernel solve on
        # THIS worker's native kernel, so that work scales with the
        # worker count instead of serializing on the parent's cores.
        from margin_tpu.ops import banded_triton, native_fb
        local_idx: list = []
        if native_fb.lib() is not None:
            for i, it in enumerate(items):
                lx, ly = len(it["x_sym"]), len(it["y_sym"])
                if lx + ly == 0:
                    continue
                geom = _item_geom(it, expansion, dynamic)
                if (geom.w_pad > banded_triton.WIDTHS[-1]
                        and _true_band_cells(geom) > _NATIVE_SCAN_CELLS_CPU):
                    local_idx.append(i)
        if local_idx:
            results = [None] * len(items)
            local_set = set(local_idx)
            remote_idx = [i for i in range(len(items))
                          if i not in local_set]
            remote_fut = None
            pool = None
            if remote_idx:
                # ship the device-eligible batch FIRST so the parent's
                # funnel works while this worker crunches its natives
                from concurrent.futures import ThreadPoolExecutor
                pool = ThreadPoolExecutor(max_workers=1)
                remote_fut = pool.submit(
                    executor.ipc_banded, tables,
                    [items[i] for i in remote_idx], expansion, threshold,
                    use_lut, dynamic)
            remote_exc = None
            try:
                for i, r in zip(local_idx, _solve_native_items(
                        tables, [items[i] for i in local_idx], expansion,
                        threshold, use_lut, dynamic)):
                    results[i] = r
            finally:
                # always drain the remote future: abandoning it would leak
                # in-flight IPC work and swallow its exceptions
                if remote_fut is not None:
                    try:
                        remote = remote_fut.result()
                    except BaseException as e:
                        remote_exc = e
                    pool.shutdown(wait=False)
            if remote_exc is not None:
                raise remote_exc
            if remote_fut is not None:
                for i, r in zip(remote_idx, remote):
                    results[i] = r
            return results
        return executor.ipc_banded(tables, items, expansion, threshold,
                                   use_lut, dynamic)
    _ensure_registered()
    if use_device_fb():
        # cross-chunk funnel: concurrent chunk threads' requests merge into
        # shared pipelined launches (polish.c:475-478's omp-parallel
        # chunks all feed the one card)
        return _FB_FUNNEL.solve(tables, items, expansion, threshold,
                                use_lut, dynamic)
    return _posteriors_many_scan(tables, items, expansion, threshold,
                                 use_lut, dynamic)


def _posteriors_many_scan(tables: PairHmmTables, items, expansion: int,
                          threshold: float = 0.01, use_lut: bool = False,
                          dynamic: bool = False, smooth=None):
    """lax.scan grouped-vmapped solve (the CPU path and accelerator
    fallback for degenerate band geometries)."""
    from margin_tpu.ops import native_fb

    results = [None] * len(items)
    groups = {}
    monster_items, monster_idx = [], []
    if smooth is None:
        smooth = _smooth_policy()
    native_cells_thresh = _native_scan_cells()  # loop-invariant
    for idx, it in enumerate(items):
        lx, ly = len(it["x_sym"]), len(it["y_sym"])
        if lx + ly == 0:
            empty = np.zeros((0, 3), dtype=np.int64)
            results[idx] = ((empty, empty, empty), 0.0)
            continue
        geom = BandGeometry.build(it["anchors"], lx, ly, expansion,
                                  dynamic=dynamic, smooth=smooth)
        if (native_fb.lib() is not None
                and _true_band_cells(geom) > native_cells_thresh):
            monster_items.append(it)
            monster_idx.append(idx)
            continue
        d_pad = _bucket_dpad(geom.d_pad)
        w_pad = int(np.ceil(geom.w_pad / 8)) * 8
        use_rle = it.get("rep_x") is not None and tables.repeat is not None
        key = (d_pad, w_pad, int(it["strand"]), use_rle, geom.pm1,
               bool(it.get("ragged_left")), bool(it.get("ragged_right")))
        groups.setdefault(key, []).append(idx)

    for (d_pad, w_pad, strand, use_rle, pm1, rl, rr), idxs in groups.items():
        # pad the batch to a power of two (repeating the last problem) so
        # the compiled kernel count stays bounded
        b_pad = 1 << int(np.ceil(np.log2(len(idxs)))) if len(idxs) > 1 else 1
        padded_idxs = idxs + [idxs[-1]] * (b_pad - len(idxs))
        xs = np.full((b_pad, d_pad), 4, dtype=np.int32)
        ys = np.full((b_pad, d_pad), 4, dtype=np.int32)
        lxs = np.zeros(b_pad, dtype=np.int32)
        lys = np.zeros(b_pad, dtype=np.int32)
        xmy_l = np.zeros((b_pad, d_pad), dtype=np.int32)
        widths = np.zeros((b_pad, d_pad), dtype=np.int32)
        x_base = np.zeros((b_pad, d_pad), dtype=np.int32)
        y_base = np.zeros((b_pad, d_pad), dtype=np.int32)
        k_los = np.zeros((b_pad, d_pad), dtype=np.int32)
        rx = np.zeros((b_pad, d_pad), dtype=np.int32)
        ry = np.zeros((b_pad, d_pad), dtype=np.int32)
        geoms = []
        for k, idx in enumerate(padded_idxs):
            it = items[idx]
            lx, ly = len(it["x_sym"]), len(it["y_sym"])
            geom = BandGeometry.build(it["anchors"], lx, ly, expansion,
                                      d_pad, w_pad, dynamic=dynamic,
                                      smooth=smooth)
            geoms.append(geom)
            xs[k, :lx] = it["x_sym"]
            ys[k, :ly] = it["y_sym"]
            lxs[k], lys[k] = lx, ly
            xmy_l[k] = geom.xmy_l
            widths[k] = geom.widths
            x_base[k] = geom.x_base
            y_base[k] = geom.y_base
            if geom.k_lo is not None:
                k_los[k] = geom.k_lo
            if use_rle:
                rx[k, :lx] = np.minimum(it["rep_x"], 50)
                ry[k, :ly] = np.minimum(it["rep_y"], 50)
        rep_kwargs = {}
        if use_rle:
            rep_kwargs = dict(rep_table=tables.repeat[strand],
                              rep_x=jnp.asarray(rx), rep_y=jnp.asarray(ry))
        xbj = jnp.asarray(x_base)
        ybj = jnp.asarray(y_base)
        post, totals = _banded_fb_many(
            tables.match[strand], tables.gap_x[strand], tables.gap_y[strand],
            tables.trans[strand],
            jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(lxs),
            jnp.asarray(lys), jnp.asarray(xmy_l), jnp.asarray(widths),
            xbj, ybj,
            rl, rr, d_pad=d_pad, w_pad=w_pad, use_lut=use_lut,
            use_rle=use_rle,
            precompute_emissions=_precompute_policy(len(padded_idxs), d_pad,
                                                    w_pad),
            pm1=pm1, k_lo=(jnp.asarray(k_los) if k_los.any() else None),
            **rep_kwargs)
        K = _extract_cap(d_pad)
        vals, pxs, pys, counts = _device_extract_many(post, xbj, ybj,
                                                      threshold, K)
        vals = np.asarray(vals)
        pxs = np.asarray(pxs)
        pys = np.asarray(pys)
        counts = np.asarray(counts)
        totals = np.asarray(totals)
        for k, idx in enumerate(idxs):
            results[idx] = (
                _pairs_from_compact(vals[k], pxs[k], pys[k], counts[k], K,
                                    post[k], geoms[k], threshold),
                float(totals[k]))
    if monster_items:
        for i, r in zip(monster_idx,
                        _solve_native_items(tables, monster_items,
                                            expansion, threshold, use_lut,
                                            dynamic)):
            results[i] = r
    return results


def banded_expectations(tables: PairHmmTables, x_sym: np.ndarray,
                        y_sym: np.ndarray, anchors, expansion: int,
                        strand: int, ragged_left=False, ragged_right=False,
                        use_lut: bool = False, pad_shapes: bool = True):
    """getExpectationsUsingAnchors (pairwiseAligner.c:1193-1209): Baum-Welch
    transition expectations over the banded forward-backward. Returns
    (E (3,3) [from, to] expected transition counts, total log prob)."""
    _ensure_registered()
    lx, ly = len(x_sym), len(y_sym)
    if lx + ly == 0:
        return np.zeros((3, 3)), 0.0
    smooth = _smooth_policy()
    geom = BandGeometry.build(anchors, lx, ly, expansion, smooth=smooth)
    d_pad, w_pad = geom.d_pad, geom.w_pad
    if pad_shapes:
        d_pad = _bucket_dpad(d_pad)
        w_pad = int(np.ceil(w_pad / 8)) * 8
        geom = BandGeometry.build(anchors, lx, ly, expansion, d_pad, w_pad,
                                  smooth=smooth)
    xs = np.full(d_pad, 4, dtype=np.int32)
    xs[:lx] = x_sym
    ys = np.full(d_pad, 4, dtype=np.int32)
    ys[:ly] = y_sym
    _post, total, exp_acc = _banded_fb(
        tables.match[strand], tables.gap_x[strand], tables.gap_y[strand],
        tables.trans[strand],
        jnp.asarray(xs), jnp.asarray(ys), lx, ly,
        jnp.asarray(geom.xmy_l), jnp.asarray(geom.widths),
        jnp.asarray(geom.x_base), jnp.asarray(geom.y_base),
        bool(ragged_left), bool(ragged_right),
        d_pad=d_pad, w_pad=w_pad, use_lut=use_lut,
        compute_expectations=True,
        precompute_emissions=_precompute_policy(1, d_pad, w_pad),
        pm1=geom.pm1,
        k_lo=None if geom.k_lo is None else jnp.asarray(geom.k_lo))
    return np.asarray(exp_acc, dtype=np.float64), float(total)


def extract_pairs_from_grid(post: np.ndarray, geom: BandGeometry,
                            threshold: float):
    """Host-side thresholding of the posterior grid into reference-style
    (weight, x-1, y-1) pair lists (addPosteriorProb, pairwiseAligner.c:598-608)."""
    PAIR1 = 10_000_000  # PAIR_ALIGNMENT_PROB_1
    k_idx = np.arange(geom.w_pad)[None, :]
    x = geom.x_base[:, None] + 1 + k_idx
    y = geom.y_base[:, None] + 1 - k_idx
    out = []
    for state, need_x, need_y in ((MATCH, True, True), (GAPX, True, False),
                                  (GAPY, False, True)):
        grid = post[:, state, :]
        sel = grid >= threshold
        if need_x:
            sel &= x > 0
        if need_y:
            sel &= y > 0
        dd, kk = np.nonzero(sel)
        probs = np.floor(np.minimum(grid[dd, kk], 1.0) * PAIR1).astype(np.int64)
        pairs = np.stack([probs, x[dd, kk] - 1, y[dd, kk] - 1], axis=1)
        # order by (x, y) like the reference's diagonal sweep ordering
        order = np.lexsort((pairs[:, 2], pairs[:, 1]))
        out.append(pairs[order])
    return tuple(out)
