"""Banded pair-HMM forward-backward as Pallas kernels on the Triton route.

Parity: getPosteriorProbsWithBanding (pairwiseAligner.c:706-844), cell for
cell the recurrence of `ops.banded._banded_fb_core` (same operation order,
same band, same start/end weights), so posteriors agree with the scan path
to float32 rounding.

Why a kernel: one banded problem is 10^4-2*10^5 dependent anti-diagonals
of ~3*W cells each (W <= 128). A `lax.scan` pays at least one device
launch per step; here the whole diagonal loop runs inside one program.

Design
------
* A pack of problems is split into programs of G problems each
  (G = max(1, 32 // W): one warp of lanes at the narrow widths); the grid
  is one program per group and nothing is carried between programs.
* Every program owns a contiguous run of diagonals in a flat, ragged
  "diagonal arena" (per-program offset `off`, length `dmax + 3`): band
  metadata, forward values and posteriors of diagonal d of problem j live
  at row off + d. A short problem therefore costs no padding to the
  pack's deepest one.
* The forward kernel writes diagonal d to the forward store, passes a
  block barrier, and reads its k-1/k/k+1 neighbours back from rows d-1 and
  d-2 of the store (an L1/L2 hit): per-problem shifts are plain gathers.
* Emissions are built in the kernel from the packed symbol arrays
  (symbol in bits 0-2, run length in bits 3+) and the per-problem tables.
* The backward kernel walks the diagonals down, keeps its own values in a
  three-row ring, reads the forward value of the same cell and overwrites
  it in place with the posterior. Cells that the extraction would drop
  (below the threshold, or on the x = 0 / y = 0 edges) are written as 0.
* The posterior extraction that follows is plain XLA (`_extract_packed`).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

from margin_tpu.ops import logmath
from margin_tpu.ops.pairhmm import (GAPX, GAPY, LOG_ZERO, MATCH,
                                    T_EXT_X, T_EXT_Y, T_MM, T_M_FROM_GX,
                                    T_M_FROM_GY, T_OPEN_X, T_OPEN_Y, T_SW_X,
                                    T_SW_Y)
from margin_tpu.utils.lazyjax import jax, jnp, lazy_jit

# per-problem float table columns
TAB_MATCH, TAB_GX, TAB_GY, TAB_TRANS, TAB_INIT, TAB_END = 0, 25, 30, 35, 44, 47
N_TAB = 64
# per-problem int columns
I_LX, I_LY, I_KFIN, I_STRAND, I_SXO, I_SYO = range(6)
N_INT = 8
# rows of the diagonal arena a program owns beyond its last diagonal: the
# backward pass reads band bases at d+1 and d+2
ARENA_TAIL = 3
REP_N = 51
WIDTHS = (16, 32, 64, 128)


def group_size(w_pad: int) -> int:
    """Problems per program: a (W, G) block of at least one warp."""
    return max(1, 32 // w_pad)


def num_warps(w_pad: int) -> int:
    return max(1, w_pad * group_size(w_pad) // 32)


def bucket_w(w: int) -> int:
    """Band-width storage bucket (power of two, as Triton blocks need)."""
    for b in WIDTHS:
        if w <= b:
            return b
    raise ValueError(f"band width {w} exceeds the device kernel's {WIDTHS[-1]}")


def _pow2(n: int, floor: int) -> int:
    return max(floor, 1 << max(0, int(n - 1).bit_length()))


# --------------------------------------------------------------------------
# kernels
# --------------------------------------------------------------------------

def _lut_log_add(x, y):
    """`logmath.log_add_lut_finite` with the cubic coefficients as Python
    scalars (a kernel cannot capture array constants). Inputs are clamped
    at the finite LOG_ZERO, so the inf/nan guards are not needed."""
    hi = jnp.maximum(x, y)
    lo = jnp.minimum(x, y)
    d = hi - lo

    def poly(i):
        a, b, c, e = (float(v) for v in logmath._CUBIC[i])
        return ((a * d + b) * d + c) * d + e

    brk = [float(v) for v in logmath._BREAKS]
    v01 = jnp.where(d > brk[0], poly(1), poly(0))
    v23 = jnp.where(d > brk[2], poly(3), poly(2))
    approx = jnp.where(d > brk[1], v23, v01) + lo
    return jnp.where(d >= logmath._LOG_UNDERFLOW_THRESHOLD, hi, approx)


def _log_add3(a, b, c, log_add):
    return log_add(log_add(a, b), c)


def _program_setup(W, G, prog_ref, ints_ref, tabs_ref):
    """Per-program scalars and (1, G) per-problem columns."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plt

    p = pl.program_id(0)
    off = plt.load(prog_ref.at[2 * p])
    dmax = plt.load(prog_ref.at[2 * p + 1])
    j = jax.lax.broadcasted_iota(jnp.int32, (1, G), 1)
    b = p * G + j
    k = jax.lax.broadcasted_iota(jnp.int32, (W, G), 0)
    jj = jax.lax.broadcasted_iota(jnp.int32, (W, G), 1)

    def ints(col):
        return plt.load(ints_ref.at[b * N_INT + col])

    def tab(col):
        return plt.load(tabs_ref.at[b * N_TAB + col])

    return p, off, dmax, b, k, jj, ints, tab


def _emissions(use_rle, b, cx_idx, cy_idx, lx, ly, sxo, syo, sx_ref, sy_ref,
               tabs_ref, rep_ref, strand):
    """Match/gapX/gapY emissions of the symbols X[cx_idx], Y[cy_idx]
    (symbol 4 outside the sequences), plus the RLE repeat overlay of
    stateMachine.c:733-738 (`_match_emission` in ops.banded)."""
    from jax.experimental.pallas import triton as plt

    okx = (cx_idx >= 0) & (cx_idx < lx)
    oky = (cy_idx >= 0) & (cy_idx < ly)
    px = plt.load(sx_ref.at[sxo + jnp.where(okx, cx_idx, 0)], mask=okx,
                  other=4)
    py = plt.load(sy_ref.at[syo + jnp.where(oky, cy_idx, 0)], mask=oky,
                  other=4)
    cx = px & 7
    cy = py & 7
    base = b * N_TAB
    e_m = plt.load(tabs_ref.at[base + TAB_MATCH + cx * 5 + cy])
    e_gx = plt.load(tabs_ref.at[base + TAB_GX + cx])
    e_gy = plt.load(tabs_ref.at[base + TAB_GY + cy])
    if use_rle:
        rx = px >> 3
        ry = py >> 3
        rb = jnp.where(cx >= 4, 0, cx)
        e_m = e_m + plt.load(rep_ref.at[
            strand * (4 * REP_N * REP_N) + rb * (REP_N * REP_N)
            + rx * REP_N + ry])
    return e_m, e_gx, e_gy


def _fwd_kernel(W, G, use_lut, use_rle, interpret,
                prog_ref, ints_ref, tabs_ref, xmy_ref, wk_ref, sx_ref,
                sy_ref, rep_ref, fwd_ref):
    """Forward sweep of one program: diagonals 0..dmax of its G problems."""
    from jax.experimental.pallas import triton as plt

    log_add = _lut_log_add if use_lut else jnp.logaddexp
    neg = jnp.float32(LOG_ZERO)
    p, off, dmax, b, k, jj, ints, tab = _program_setup(
        W, G, prog_ref, ints_ref, tabs_ref)
    lx, ly = ints(I_LX), ints(I_LY)
    sxo, syo, strand = ints(I_SXO), ints(I_SYO), ints(I_STRAND)
    trc = [tab(TAB_TRANS + t) for t in range(9)]
    row = 3 * W * G
    cell = k * G + jj

    def barrier():
        if not interpret:
            plt.debug_barrier()

    def store(d, vals):
        for s in range(3):
            plt.store(fwd_ref.at[(off + d) * row + s * W * G + cell], vals[s])

    def neighbour(d, s, shift):
        kk = k + shift
        ok = (kk >= 0) & (kk < W) & (d >= 0)
        idx = (off + d) * row + s * W * G + jnp.where(ok, kk, 0) * G + jj
        return plt.load(fwd_ref.at[jnp.where(ok, idx, 0)], mask=ok,
                        other=neg)

    # diagonal 0: the start-state weights at k = 0 (stateMachine.c:521-530)
    store(0, [jnp.where(k == 0, tab(TAB_INIT + s), neg) for s in range(3)])
    barrier()

    def body(d, carry):
        rb = (off + d) * G + jj
        xm0 = plt.load(xmy_ref.at[rb])
        xm1 = plt.load(xmy_ref.at[rb - G])
        xm2 = plt.load(xmy_ref.at[jnp.where(d >= 2, rb - 2 * G, rb)])
        s1 = (xm0 - 1 - xm1) >> 1
        s2 = (xm0 - xm2) >> 1
        wk = plt.load(wk_ref.at[rb])
        width = wk & 0xFFFF
        k_lo = wk >> 16
        x_base = ((d + xm0) >> 1) - 1
        y_base = ((d - xm0) >> 1) - 1
        e_m, e_gx, e_gy = _emissions(
            use_rle, b, x_base + k, y_base - k, lx, ly, sxo, syo, sx_ref,
            sy_ref, tabs_ref, rep_ref, strand)
        low = [neighbour(d - 1, s, s1) for s in range(3)]       # (x-1, y)
        up = [neighbour(d - 1, s, s1 + 1) for s in range(3)]    # (x, y-1)
        mid = [neighbour(d - 2, s, s2) for s in range(3)]       # (x-1, y-1)
        new_gx = e_gx + _log_add3(low[MATCH] + trc[T_OPEN_X],
                                  low[GAPX] + trc[T_EXT_X],
                                  low[GAPY] + trc[T_SW_X], log_add)
        new_m = e_m + _log_add3(mid[MATCH] + trc[T_MM],
                                mid[GAPX] + trc[T_M_FROM_GX],
                                mid[GAPY] + trc[T_M_FROM_GY], log_add)
        new_gy = e_gy + _log_add3(up[MATCH] + trc[T_OPEN_Y],
                                  up[GAPY] + trc[T_EXT_Y],
                                  up[GAPX] + trc[T_SW_Y], log_add)
        x_pos = x_base + 1 + k
        y_pos = y_base + 1 - k
        vm = ((k >= k_lo) & (k < width) & (x_pos >= 0) & (x_pos <= lx)
              & (y_pos >= 0) & (y_pos <= ly) & (d <= lx + ly))
        store(d, [jnp.maximum(jnp.where(vm, v, neg), neg)
                  for v in (new_m, new_gx, new_gy)])
        barrier()
        return carry

    jax.lax.fori_loop(1, dmax + 1, body, 0)


def _bwd_kernel(W, G, use_lut, use_rle, interpret, threshold,
                prog_ref, ints_ref, tabs_ref, xmy_ref, wk_ref, sx_ref,
                sy_ref, rep_ref, tot_ref, fwd_in_ref, post_ref, ring_ref):
    """Backward sweep + posteriors of one program, in place over the
    forward store."""
    del fwd_in_ref  # aliased to post_ref
    from jax.experimental.pallas import triton as plt

    log_add = _lut_log_add if use_lut else jnp.logaddexp
    neg = jnp.float32(LOG_ZERO)
    p, off, dmax, b, k, jj, ints, tab = _program_setup(
        W, G, prog_ref, ints_ref, tabs_ref)
    lx, ly = ints(I_LX), ints(I_LY)
    sxo, syo, strand = ints(I_SXO), ints(I_SYO), ints(I_STRAND)
    k_final = ints(I_KFIN)
    d_final = lx + ly
    trc = [tab(TAB_TRANS + t) for t in range(9)]
    end_w = [tab(TAB_END + s) for s in range(3)]
    total = plt.load(tot_ref.at[b])
    row = 3 * W * G
    cell = k * G + jj
    ring_base = p * (3 * row)

    def barrier():
        if not interpret:
            plt.debug_barrier()

    def ring_at(d, s, shift):
        kk = k + shift
        ok = (kk >= 0) & (kk < W)
        idx = (ring_base + (d % 3) * row + s * W * G
               + jnp.where(ok, kk, 0) * G + jj)
        return plt.load(ring_ref.at[idx], mask=ok, other=neg)

    for slot in range(3):
        for s in range(3):
            plt.store(ring_ref.at[ring_base + slot * row + s * W * G + cell],
                      jnp.full((W, G), neg, jnp.float32))
    # the program's tail rows (dmax+1, dmax+2) hold no diagonal: zero them
    # so the extraction finds no stale memory there
    for t in range(1, ARENA_TAIL):
        for s in range(3):
            plt.store(post_ref.at[(off + dmax + t) * row + s * W * G + cell],
                      jnp.zeros((W, G), jnp.float32))
    barrier()

    def body(i, carry):
        d = dmax - i
        rb = (off + d) * G + jj
        xm0 = plt.load(xmy_ref.at[rb])
        xn1 = plt.load(xmy_ref.at[rb + G])
        xn2 = plt.load(xmy_ref.at[rb + 2 * G])
        t1 = (xm0 + 1 - xn1) >> 1
        t2 = (xm0 - xn2) >> 1
        wk = plt.load(wk_ref.at[rb])
        width = wk & 0xFFFF
        k_lo = wk >> 16
        x_base = ((d + xm0) >> 1) - 1
        y_base = ((d - xm0) >> 1) - 1
        # symbols consumed LEAVING cell k: X[x], Y[y]
        e_m, e_gx, e_gy = _emissions(
            use_rle, b, x_base + 1 + k, y_base + 1 - k, lx, ly, sxo, syo,
            sx_ref, sy_ref, tabs_ref, rep_ref, strand)
        gx_n = ring_at(d + 1, GAPX, t1)         # (x+1, y)
        gy_n = ring_at(d + 1, GAPY, t1 - 1)     # (x, y+1)
        m_n = ring_at(d + 2, MATCH, t2)         # (x+1, y+1)
        b_m = _log_add3(gx_n + e_gx + trc[T_OPEN_X],
                        m_n + e_m + trc[T_MM],
                        gy_n + e_gy + trc[T_OPEN_Y], log_add)
        b_gx = _log_add3(gx_n + e_gx + trc[T_EXT_X],
                         m_n + e_m + trc[T_M_FROM_GX],
                         gy_n + e_gy + trc[T_SW_Y], log_add)
        b_gy = _log_add3(gx_n + e_gx + trc[T_SW_X],
                         m_n + e_m + trc[T_M_FROM_GY],
                         gy_n + e_gy + trc[T_EXT_Y], log_add)
        x_pos = x_base + 1 + k
        y_pos = y_base + 1 - k
        vm = ((k >= k_lo) & (k < width) & (x_pos >= 0) & (x_pos <= lx)
              & (y_pos >= 0) & (y_pos <= ly) & (d <= d_final))
        at_end = (d == d_final) & (k == k_final)
        # the final diagonal carries the end-state weights at k_final
        # (pairwiseAligner.c:882-892)
        for s, v in enumerate((b_m, b_gx, b_gy)):
            computed = jnp.maximum(jnp.where(vm, v, neg), neg)
            cur = jnp.where(d == d_final, jnp.where(at_end, end_w[s], neg),
                            computed)
            plt.store(ring_ref.at[ring_base + (d % 3) * row + s * W * G
                                  + cell], cur)
            idx = (off + d) * row + s * W * G + cell
            f_d = plt.load(post_ref.at[idx])
            post = jnp.exp(jnp.minimum(f_d + cur - total, 0.0))
            keep = vm & (post >= threshold)
            if s != GAPY:
                keep = keep & (x_pos > 0)
            if s != GAPX:
                keep = keep & (y_pos > 0)
            plt.store(post_ref.at[idx], jnp.where(keep, post, 0.0))
        barrier()
        return carry

    jax.lax.fori_loop(0, dmax + 1, body, 0)


# --------------------------------------------------------------------------
# device program: forward kernel, totals, backward kernel, extraction
# --------------------------------------------------------------------------

@lazy_jit(static_argnames=("w_pad", "n_rows", "use_lut", "use_rle",
                           "threshold", "K", "interpret"))
def _fb_device(prog, ints, tabs, xmy, wk, sx, sy, rep, tot_idx, used,
               *, w_pad: int, n_rows: int, use_lut: bool, use_rle: bool,
               threshold: float, K: int, interpret: bool):
    """Run one pack. Returns ONE int32 array (one readback per pack):
    [count, totals (bitcast f32, B_pad), cell indices (K), probs (K)].
    A cell index is the flat position in the (row, state, k, j) arena;
    the host decodes it against the band bases it built."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plt

    W = w_pad
    G = group_size(W)
    n_prog = prog.shape[0] // 2
    cells = n_rows * 3 * W * G
    params = plt.CompilerParams(num_warps=num_warps(W), num_stages=1)
    common = (prog, ints, tabs, xmy, wk, sx, sy, rep)

    fwd = pl.pallas_call(
        functools.partial(_fwd_kernel, W, G, use_lut, use_rle, interpret),
        out_shape=jax.ShapeDtypeStruct((cells,), jnp.float32),
        grid=(n_prog,),
        backend="triton",
        compiler_params=params,
        interpret=interpret,
        name="banded_fb_forward",
    )(*common)

    # total log prob at each problem's final corner (lx, ly)
    la = _lut_log_add if use_lut else jnp.logaddexp
    f3 = fwd[tot_idx[:, None] + jnp.arange(3)[None, :] * (W * G)]
    end_w = tabs.reshape(-1, N_TAB)[:, TAB_END:TAB_END + 3]
    t = f3 + end_w
    totals = la(la(t[:, 0], t[:, 1]), t[:, 2])

    post, _ring = pl.pallas_call(
        functools.partial(_bwd_kernel, W, G, use_lut, use_rle, interpret,
                          float(threshold)),
        out_shape=(jax.ShapeDtypeStruct((cells,), jnp.float32),
                   jax.ShapeDtypeStruct((n_prog * 9 * W * G,), jnp.float32)),
        grid=(n_prog,),
        input_output_aliases={9: 0},
        backend="triton",
        compiler_params=params,
        interpret=interpret,
        name="banded_fb_backward",
    )(*common, totals, fwd)

    return _extract_packed(post, used, totals, K)


def _extract_packed(post, used, totals, K: int):
    """addPosteriorProb compaction (pairwiseAligner.c:598-608): every kept
    cell (the backward kernel zeroed the rest) as (flat index, prob
    scaled by PAIR_ALIGNMENT_PROB_1), fused with the totals into one
    array."""
    sel = (post > 0) & (jnp.arange(post.shape[0]) < used)
    count = jnp.sum(sel, dtype=jnp.int32)
    (idx,) = jnp.nonzero(sel, size=K, fill_value=0)
    probs = jnp.floor(jnp.minimum(post[idx], 1.0)
                      * 10_000_000).astype(jnp.int32)
    tb = jax.lax.bitcast_convert_type(totals.astype(jnp.float32), jnp.int32)
    return jnp.concatenate([count[None], tb, idx.astype(jnp.int32), probs])


# --------------------------------------------------------------------------
# host side: packing and unpacking
# --------------------------------------------------------------------------

@dataclass
class HostPack:
    """Host arrays of one pack (ragged diagonal arena, see module doc)."""
    w_pad: int
    n_real: int
    b_pad: int
    n_rows: int
    used: int
    prog: np.ndarray     # (2 * n_prog,) int32: offset, dmax per program
    ints: np.ndarray     # (b_pad * N_INT,) int32
    tabs: np.ndarray     # (b_pad * N_TAB,) float32
    xmy: np.ndarray      # (n_rows * G,) int32 storage base per diagonal
    wk: np.ndarray       # (n_rows * G,) int32: width | k_lo << 16
    sx: np.ndarray       # packed symbols | run length << 3
    sy: np.ndarray
    tot_idx: np.ndarray  # (b_pad,) int32
    sum_d: int


def pack_cells(geoms, w_pad: int) -> int:
    """Arena cells (forward store size) a pack of these geometries needs."""
    G = group_size(w_pad)
    d = sorted((g.lx + g.ly for g in geoms), reverse=True)
    rows = sum(d[i] + ARENA_TAIL for i in range(0, len(d), G))
    return rows * 3 * w_pad * G


def build_pack(tables, items, geoms, w_pad: int, use_rle: bool) -> HostPack:
    """items/geoms: the pack's problems (unpadded smoothed geometry from
    `BandGeometry.build(smooth=True)`), ordered by depth, deepest first,
    so each program's G problems have similar depth."""
    G = group_size(w_pad)
    n = len(items)
    n_prog = _pow2(-(-n // G), 1)
    b_pad = n_prog * G
    depths = [g.lx + g.ly for g in geoms]
    prog = np.zeros(2 * n_prog, np.int32)
    off = 0
    for p in range(n_prog):
        grp = depths[p * G:(p + 1) * G]
        dmax = max(grp) if grp else 0
        prog[2 * p], prog[2 * p + 1] = off, dmax
        off += (dmax + ARENA_TAIL) if grp else 0
    used_rows = off
    n_rows = _pow2(used_rows + ARENA_TAIL, 1024)
    xmy = np.zeros((n_rows, G), np.int32)
    wk = np.zeros((n_rows, G), np.int32)
    ints = np.zeros((b_pad, N_INT), np.int32)
    tabs = np.zeros((b_pad, N_TAB), np.float32)
    lens_x = [len(it["x_sym"]) for it in items]
    lens_y = [len(it["y_sym"]) for it in items]
    sx = np.full(_pow2(sum(lens_x) + 1, 1024), 4, np.int32)
    sy = np.full(_pow2(sum(lens_y) + 1, 1024), 4, np.int32)
    match = np.asarray(tables.match, np.float32)
    gap_x = np.asarray(tables.gap_x, np.float32)
    gap_y = np.asarray(tables.gap_y, np.float32)
    trans = np.asarray(tables.trans, np.float32)
    neg = np.float32(LOG_ZERO)
    tot_idx = np.zeros(b_pad, np.int32)
    ox = oy = 0
    W, row = w_pad, 3 * w_pad * G
    for b, (it, g) in enumerate(zip(items, geoms)):
        p, j = divmod(b, G)
        o = int(prog[2 * p])
        d_len = int(prog[2 * p + 1]) + 1
        lx, ly = g.lx, g.ly
        dr = lx + ly + 1
        xmy[o:o + dr, j] = g.xmy_l[:dr]
        w = g.widths[:dr].astype(np.int32)
        if g.k_lo is not None:
            w = w | (g.k_lo[:dr].astype(np.int32) << 16)
        wk[o:o + dr, j] = w
        assert d_len >= dr
        strand = int(it["strand"])
        k_final = (lx - ly - int(g.xmy_l[lx + ly])) // 2
        ints[b, :6] = (lx, ly, k_final, strand, ox, oy)
        if use_rle:
            sx[ox:ox + lx] = (np.asarray(it["x_sym"], np.int32)
                              | (np.minimum(it["rep_x"], 50).astype(np.int32)
                                 << 3))
            sy[oy:oy + ly] = (np.asarray(it["y_sym"], np.int32)
                              | (np.minimum(it["rep_y"], 50).astype(np.int32)
                                 << 3))
        else:
            sx[ox:ox + lx] = it["x_sym"]
            sy[oy:oy + ly] = it["y_sym"]
        ox += lx
        oy += ly
        t = tabs[b]
        t[TAB_MATCH:TAB_MATCH + 25] = match[strand]
        t[TAB_GX:TAB_GX + 5] = gap_x[strand]
        t[TAB_GY:TAB_GY + 5] = gap_y[strand]
        tr = trans[strand]
        t[TAB_TRANS:TAB_TRANS + 9] = tr
        t[TAB_INIT:TAB_INIT + 3] = ((neg, 0.0, 0.0) if it.get("ragged_left")
                                    else (0.0, neg, neg))
        t[TAB_END:TAB_END + 3] = (
            ((tr[T_OPEN_X] + tr[T_OPEN_Y]) / np.float32(2.0), tr[T_EXT_X],
             tr[T_EXT_Y]) if it.get("ragged_right")
            else (tr[T_MM], tr[T_M_FROM_GX], tr[T_M_FROM_GY]))
        tot_idx[b] = (o + lx + ly) * row + k_final * G + j
    # pad problems: empty sequences on strand 0 in the last program's
    # free lanes (their cells are masked out by lx = ly = 0)
    return HostPack(w_pad, n, b_pad, n_rows, used_rows * row, prog,
                    ints.ravel(), tabs.ravel(), xmy.ravel(), wk.ravel(),
                    sx, sy, tot_idx, sum(depths) + n)


def k_for(n_pairs_guess: float) -> int:
    """Static extraction capacity: powers of 4 from 16384, so a drifting
    guess rarely forces a new compile."""
    K = 16384
    while K < n_pairs_guess:
        K *= 4
    return K


def launch(tables, pack: HostPack, use_lut: bool, use_rle: bool,
           threshold: float, K: int, interpret: bool = False):
    """Enqueue one pack; returns the (device) packed result array."""
    rep = (jnp.asarray(np.asarray(tables.repeat, np.float32).ravel())
           if use_rle else jnp.zeros((1,), jnp.float32))
    return _fb_device(
        jnp.asarray(pack.prog), jnp.asarray(pack.ints),
        jnp.asarray(pack.tabs), jnp.asarray(pack.xmy), jnp.asarray(pack.wk),
        jnp.asarray(pack.sx), jnp.asarray(pack.sy), rep,
        jnp.asarray(pack.tot_idx), jnp.int32(pack.used),
        w_pad=pack.w_pad, n_rows=pack.n_rows, use_lut=use_lut,
        use_rle=use_rle, threshold=float(threshold), K=K,
        interpret=interpret)


def unpack(pack: HostPack, arr: np.ndarray, K: int):
    """Decode a packed readback into per-problem ((matches, gapx, gapy),
    total) results, pairs as (prob, x, y) sorted by (x, y). Returns None
    if the K cells overflowed (the caller re-launches with a larger K)."""
    count = int(arr[0])
    if count > K:
        return None
    nb = pack.b_pad
    totals = arr[1:1 + nb].view(np.float32).astype(np.float64)
    idx = arr[1 + nb:1 + nb + count].astype(np.int64)
    probs = arr[1 + nb + K:1 + nb + K + count].astype(np.int64)
    W, G = pack.w_pad, group_size(pack.w_pad)
    row = 3 * W * G
    r, rem = np.divmod(idx, row)
    s, rem = np.divmod(rem, W * G)
    k, j = np.divmod(rem, G)
    offs = pack.prog[0::2].astype(np.int64)
    # rows below `used` belong to real programs, whose offsets are
    # strictly increasing
    p = np.searchsorted(offs, r, side="right") - 1
    d = r - offs[p]
    b = p * G + j
    xm = pack.xmy[r * G + j].astype(np.int64)
    xs = ((d + xm) >> 1) - 1 + k          # x_pos - 1
    ys = ((d - xm) >> 1) - 1 - k          # y_pos - 1
    tag = b * 3 + s
    order = np.lexsort((ys, xs, tag))
    probs, xs, ys, tag = probs[order], xs[order], ys[order], tag[order]
    bounds = np.searchsorted(tag, np.arange(3 * pack.n_real + 1))
    out = []
    for i in range(pack.n_real):
        per = []
        for st in range(3):
            a, e = bounds[3 * i + st], bounds[3 * i + st + 1]
            per.append(np.stack([probs[a:e], xs[a:e], ys[a:e]],
                                axis=1).astype(np.int64))
        out.append((tuple(per), float(totals[i])))
    return out
