"""Numpy oracle: a direct, slow reimplementation of the reference's banded
pair-HMM (impl/pairwiseAligner.c + impl/stateMachine.c) used to validate the
device kernels cell-by-cell on small inputs.

Float64 throughout with the reference's cubic-LUT logAdd
(pairwiseAligner.c:279-299), so values match the C code to rounding order.
Not a compute path — tests only.
"""

from __future__ import annotations

import numpy as np

from margin_tpu.ops.logmath import np_log_add_lut
from margin_tpu.params import StateMachineParams

LOG_ZERO = -np.inf

MATCH, GAPX, GAPY = 0, 1, 2


def _set_diags_vec(xs: np.ndarray, xl: int, yl: int, xu: int, yu: int):
    """set_diag (pairwiseAligner.c:90-113) vectorized over diagonals."""
    d = xl - yl
    xmy_l = d + ((xs + d) & 1)
    i = (xs + xmy_l) >> 1
    xmy_l = np.where(i < xl, xmy_l + 2 * (xl - i), xmy_l)
    j = (xs - xmy_l) >> 1
    xmy_l = np.where(yl < j, xmy_l + 2 * (j - yl), xmy_l)
    d = xu - yu
    xmy_r = d + ((xs + d) & 1)
    i = (xs + xmy_r) >> 1
    xmy_r = np.where(xu < i, xmy_r - 2 * (i - xu), xmy_r)
    j = (xs - xmy_r) >> 1
    xmy_r = np.where(j < yu, xmy_r - 2 * (yu - j), xmy_r)
    return xmy_l, xmy_r


def build_band(anchors, lx: int, ly: int, expansion: int,
               dynamic: bool = False):
    """Band construction (pairwiseAligner.c:175-226 fixed;
    :120-173 dynamic): per-diagonal [xmyL, xmyR] ranges from anchor pairs
    (x, y[, expansion]). With dynamic=True the expansion comes from each
    anchor's third element (band_constructDynamic). Returns int64 array
    (lx+ly+1, 2).

    Band corner parameters change only when an anchor is consumed, so the
    corner sets are computed for all consumptions at once and every
    diagonal gathers its segment's corners — fully vectorized even for
    dense (per-position) anchor ladders."""
    total = lx + ly
    diags = np.zeros((total + 1, 2), dtype=np.int64)
    n = len(anchors)

    # consumption targets: each anchor, then the terminal corner (lx, ly)
    if n:
        arr = np.asarray(anchors, dtype=np.int64)
        ax = np.concatenate([arr[:, 0] + 1, [lx]])
        ay = np.concatenate([arr[:, 1] + 1, [ly]])
        if dynamic:
            exps = np.concatenate([arr[:, 2],
                                   [arr[-1, 2]]])  # terminal keeps last exp
        else:
            exps = np.full(n + 1, expansion, dtype=np.int64)
    else:
        ax = np.array([lx], dtype=np.int64)
        ay = np.array([ly], dtype=np.int64)
        exps = np.array([0 if dynamic else expansion], dtype=np.int64)

    nxay = ax + ay
    nxmy = ax - ay
    pxay = np.concatenate([[0], nxay[:-1]])
    pxmy = np.concatenate([[0], nxmy[:-1]])
    # corner set c_i produced by consumption i (pairwiseAligner.c:199-222)
    xl = np.clip((pxay + pxmy - exps) // 2, 0, lx)
    yl = np.clip((nxay - (nxmy - exps)) // 2, 0, ly)
    xu = np.clip((nxay + nxmy + exps) // 2, 0, lx)
    yu = np.clip((pxay - (pxmy + exps)) // 2, 0, ly)

    # diagonal d in (b_{i-1}, b_i] uses c_{i-1}; b = consumption diagonals
    if total > 0:
        xs = np.arange(1, total + 1)
        seg = np.searchsorted(nxay, xs, side="left")
        seg = np.minimum(seg, len(nxay) - 1)
        l, r = _set_diags_vec(xs, xl[seg], yl[seg], xu[seg], yu[seg])
        diags[1:, 0] = l
        diags[1:, 1] = r
    # diagonal 0 uses the pre-consumption zero corners: (0, 0)
    return diags


class OracleStateMachine:
    """Mirror of StateMachine3 + NucleotideEmissions (and the RLE overlay,
    stateMachine.c:716-752)."""

    def __init__(self, smp: StateMachineParams, repeat_matrix=None,
                 forward_strand: bool = True):
        self.smp = smp
        self.repeat = repeat_matrix
        self.forward_strand = forward_strand

    def e_match(self, cx, cy):
        xb, yb = cx & 255, cy & 255
        p = (np.log(0.25 ** 2) if (xb >= 4 or yb >= 4)
             else self.smp.match_probs[xb, yb])
        if self.repeat is not None:
            p += 2.3025 * self.repeat.get(int(xb), self.forward_strand,
                                          int(cy) >> 8, int(cx) >> 8)
        return p

    def e_gap_x(self, cx):
        xb = cx & 255
        return np.log(0.25) if xb >= 4 else self.smp.gap_x_probs[xb]

    def e_gap_y(self, cy):
        yb = cy & 255
        return np.log(0.25) if yb >= 4 else self.smp.gap_y_probs[yb]

    def start(self, ragged: bool):
        s = self.smp
        del s
        if ragged:  # stateMachine.c:527-530
            return np.array([LOG_ZERO, 0.0, 0.0])
        return np.array([0.0, LOG_ZERO, LOG_ZERO])  # stateMachine.c:521-525

    def end(self, ragged: bool):
        s = self.smp
        if ragged:  # stateMachine.c:547-560
            return np.array([(s.t_gap_open_x + s.t_gap_open_y) / 2.0,
                             s.t_gap_extend_x, s.t_gap_extend_y])
        return np.array([s.t_match_continue, s.t_match_from_gap_x,
                         s.t_match_from_gap_y])  # stateMachine.c:532-545


def oracle_forward_matrix(sm: OracleStateMachine, sx, sy, anchors=None,
                          expansion: int = 0, ragged_left: bool = False):
    """Dense forward matrix restricted to the band. Returns (lx+1, ly+1, 3)
    float64. Mirrors diagonalCalculationForward over band diagonals
    (pairwiseAligner.c:547-570)."""
    sx = np.asarray(sx)
    sy = np.asarray(sy)
    lx, ly = len(sx), len(sy)
    band = build_band([] if anchors is None else anchors, lx, ly, expansion)
    f = np.full((lx + 1, ly + 1, 3), LOG_ZERO)
    smp = sm.smp
    # init diag 0
    xmy_l, xmy_r = band[0]
    assert xmy_l == 0 and xmy_r == 0
    f[0, 0] = sm.start(ragged_left)
    in_band = np.zeros((lx + 1, ly + 1), dtype=bool)
    in_band[0, 0] = True
    for d in range(1, lx + ly + 1):
        xmy_l, xmy_r = band[d]
        for xmy in range(xmy_l, xmy_r + 1, 2):
            x = (d + xmy) // 2
            y = (d - xmy) // 2
            if not (0 <= x <= lx and 0 <= y <= ly):
                continue
            in_band[x, y] = True
            cx = sx[x - 1] if x > 0 else 4
            cy = sy[y - 1] if y > 0 else 4
            cell = np.full(3, LOG_ZERO)
            # lower (gapX): from (x-1, y), consumes cx
            if x > 0 and in_band[x - 1, y]:
                ep = sm.e_gap_x(cx)
                src = f[x - 1, y]
                cell[GAPX] = np_log_add_lut(cell[GAPX], src[MATCH] + ep + smp.t_gap_open_x)
                cell[GAPX] = np_log_add_lut(cell[GAPX], src[GAPX] + ep + smp.t_gap_extend_x)
                cell[GAPX] = np_log_add_lut(cell[GAPX], src[GAPY] + ep + smp.t_gap_switch_to_x)
            # middle (match): from (x-1, y-1)
            if x > 0 and y > 0 and in_band[x - 1, y - 1]:
                ep = sm.e_match(cx, cy)
                src = f[x - 1, y - 1]
                cell[MATCH] = np_log_add_lut(cell[MATCH], src[MATCH] + ep + smp.t_match_continue)
                cell[MATCH] = np_log_add_lut(cell[MATCH], src[GAPX] + ep + smp.t_match_from_gap_x)
                cell[MATCH] = np_log_add_lut(cell[MATCH], src[GAPY] + ep + smp.t_match_from_gap_y)
            # upper (gapY): from (x, y-1), consumes cy
            if y > 0 and in_band[x, y - 1]:
                ep = sm.e_gap_y(cy)
                src = f[x, y - 1]
                cell[GAPY] = np_log_add_lut(cell[GAPY], src[MATCH] + ep + smp.t_gap_open_y)
                cell[GAPY] = np_log_add_lut(cell[GAPY], src[GAPY] + ep + smp.t_gap_extend_y)
                cell[GAPY] = np_log_add_lut(cell[GAPY], src[GAPX] + ep + smp.t_gap_switch_to_y)
            f[x, y] = cell
    return f


def oracle_forward_probability(sm: OracleStateMachine, sx, sy, anchors=None,
                               expansion: int = 0, ragged_left=False,
                               ragged_right=False) -> float:
    """computeForwardProbability (pairwiseAligner.c:849-903): forward over
    the band, terminated with end-state weights at the final corner."""
    lx, ly = len(sx), len(sy)
    if lx + ly == 0:
        return 0.0
    f = oracle_forward_matrix(sm, sx, sy, anchors, expansion, ragged_left)
    end = sm.end(ragged_right)
    total = LOG_ZERO
    for s in range(3):
        total = np_log_add_lut(total, f[lx, ly, s] + end[s])
    return float(total)


def oracle_backward_matrix(sm: OracleStateMachine, sx, sy, anchors=None,
                           expansion: int = 0, ragged_right: bool = False):
    """Dense backward matrix over the band: b[x,y,s] = P(emit suffix | state s
    at (x,y)). Mirrors cell_calculateBackward semantics
    (pairwiseAligner.c:322-331)."""
    sx = np.asarray(sx)
    sy = np.asarray(sy)
    lx, ly = len(sx), len(sy)
    band = build_band([] if anchors is None else anchors, lx, ly, expansion)
    in_band = np.zeros((lx + 1, ly + 1), dtype=bool)
    for d in range(0, lx + ly + 1):
        xmy_l, xmy_r = band[d]
        for xmy in range(xmy_l, xmy_r + 1, 2):
            x, y = (d + xmy) // 2, (d - xmy) // 2
            if 0 <= x <= lx and 0 <= y <= ly:
                in_band[x, y] = True
    b = np.full((lx + 1, ly + 1, 3), LOG_ZERO)
    b[lx, ly] = sm.end(ragged_right)
    smp = sm.smp
    for d in range(lx + ly - 1, -1, -1):
        xmy_l, xmy_r = band[d]
        for xmy in range(xmy_l, xmy_r + 1, 2):
            x, y = (d + xmy) // 2, (d - xmy) // 2
            if not (0 <= x <= lx and 0 <= y <= ly and in_band[x, y]):
                continue
            cell = np.full(3, LOG_ZERO)
            # to gapX at (x+1, y)
            if x < lx and in_band[x + 1, y]:
                ep = sm.e_gap_x(sx[x])
                dst = b[x + 1, y]
                cell[MATCH] = np_log_add_lut(cell[MATCH], dst[GAPX] + ep + smp.t_gap_open_x)
                cell[GAPX] = np_log_add_lut(cell[GAPX], dst[GAPX] + ep + smp.t_gap_extend_x)
                cell[GAPY] = np_log_add_lut(cell[GAPY], dst[GAPX] + ep + smp.t_gap_switch_to_x)
            # to match at (x+1, y+1)
            if x < lx and y < ly and in_band[x + 1, y + 1]:
                ep = sm.e_match(sx[x], sy[y])
                dst = b[x + 1, y + 1]
                cell[MATCH] = np_log_add_lut(cell[MATCH], dst[MATCH] + ep + smp.t_match_continue)
                cell[GAPX] = np_log_add_lut(cell[GAPX], dst[MATCH] + ep + smp.t_match_from_gap_x)
                cell[GAPY] = np_log_add_lut(cell[GAPY], dst[MATCH] + ep + smp.t_match_from_gap_y)
            # to gapY at (x, y+1)
            if y < ly and in_band[x, y + 1]:
                ep = sm.e_gap_y(sy[y])
                dst = b[x, y + 1]
                cell[MATCH] = np_log_add_lut(cell[MATCH], dst[GAPY] + ep + smp.t_gap_open_y)
                cell[GAPY] = np_log_add_lut(cell[GAPY], dst[GAPY] + ep + smp.t_gap_extend_y)
                cell[GAPX] = np_log_add_lut(cell[GAPX], dst[GAPY] + ep + smp.t_gap_switch_to_y)
            b[x, y] = cell
    return b


def oracle_posteriors(sm: OracleStateMachine, sx, sy, anchors=None,
                      expansion: int = 0, ragged_left=False, ragged_right=False,
                      threshold: float = 0.01):
    """Aligned-pair / gap posterior extraction
    (diagonalCalculationPosteriorProbs, pairwiseAligner.c:637-681), computed
    from full-band FB with a single global total probability.

    Returns (match_pairs, gapx_pairs, gapy_pairs, total): lists of
    (prob, x, y) with prob in [threshold, 1], coordinates 0-based sequence
    coords for matches; for gaps, (x-1, y-1) of the cell coordinate like the
    reference (x>0 / y>0 checks)."""
    f = oracle_forward_matrix(sm, sx, sy, anchors, expansion, ragged_left)
    b = oracle_backward_matrix(sm, sx, sy, anchors, expansion, ragged_right)
    lx, ly = len(sx), len(sy)
    total = LOG_ZERO
    for s in range(3):
        total = np_log_add_lut(total, f[lx, ly, s] + b[lx, ly, s])
    matches, gxs, gys = [], [], []
    for x in range(lx + 1):
        for y in range(ly + 1):
            if np.isinf(f[x, y, MATCH]) and np.isinf(f[x, y, GAPX]) and np.isinf(f[x, y, GAPY]):
                continue
            if x > 0 and y > 0:
                p = np.exp(f[x, y, MATCH] + b[x, y, MATCH] - total)
                if p >= threshold:
                    matches.append((min(p, 1.0), x - 1, y - 1))
            if x > 0:
                p = np.exp(f[x, y, GAPX] + b[x, y, GAPX] - total)
                if p >= threshold:
                    gxs.append((min(p, 1.0), x - 1, y - 1))
            if y > 0:
                p = np.exp(f[x, y, GAPY] + b[x, y, GAPY] - total)
                if p >= threshold:
                    gys.append((min(p, 1.0), x - 1, y - 1))
    return matches, gxs, gys, float(total)


def oracle_forward_total_batch(sm_fwd: StateMachineParams,
                               sm_rev: StateMachineParams, pairs, strands,
                               ragged_left=None, ragged_right=None):
    """`oracle_forward_probability` with no anchors (the full rectangle)
    for a batch of (x, y) symbol pairs at once: the same float64 cell
    recurrence and LUT logAdd, vectorized over the batch instead of looped
    per pair. Returns (B,) float64 totals."""
    B = len(pairs)
    lxs = np.array([len(p[0]) for p in pairs])
    lys = np.array([len(p[1]) for p in pairs])
    LX, LY = int(lxs.max()), int(lys.max())
    xs = np.full((B, LX + 1), 4, np.int64)
    ys = np.full((B, LY + 1), 4, np.int64)
    for b, (x, y) in enumerate(pairs):
        xs[b, 1:len(x) + 1] = x
        ys[b, 1:len(y) + 1] = y
    st = np.asarray(strands, np.int64)
    sms = (sm_fwd, sm_rev)
    match = np.stack([s.match_probs for s in sms])[st]         # (B, 5, 5)
    gapx = np.stack([s.gap_x_probs for s in sms])[st]          # (B, 5)
    gapy = np.stack([s.gap_y_probs for s in sms])[st]
    tr = np.stack([s.transition_vector() for s in sms])[st]    # (B, 9)
    (t_mm, t_mgx, t_mgy, t_ox, t_oy, t_ex, t_ey, t_swx, t_swy) = tr.T
    rl = (np.zeros(B, bool) if ragged_left is None
          else np.asarray(ragged_left, bool))
    rr = (np.zeros(B, bool) if ragged_right is None
          else np.asarray(ragged_right, bool))
    ar = np.arange(B)
    f = np.full((LX + 1, LY + 1, 3, B), LOG_ZERO)
    f[0, 0, MATCH] = np.where(rl, LOG_ZERO, 0.0)
    f[0, 0, GAPX] = np.where(rl, 0.0, LOG_ZERO)
    f[0, 0, GAPY] = f[0, 0, GAPX]
    la = np_log_add_lut
    for x in range(LX + 1):
        cx = xs[:, x]
        for y in range(LY + 1):
            if x == 0 and y == 0:
                continue
            cy = ys[:, y]
            cell = np.full((3, B), LOG_ZERO)
            if x > 0:
                src = f[x - 1, y]
                ep = gapx[ar, cx]
                cell[GAPX] = la(la(la(cell[GAPX], src[MATCH] + ep + t_ox),
                                   src[GAPX] + ep + t_ex),
                                src[GAPY] + ep + t_swx)
            if x > 0 and y > 0:
                src = f[x - 1, y - 1]
                ep = match[ar, cx, cy]
                cell[MATCH] = la(la(la(cell[MATCH], src[MATCH] + ep + t_mm),
                                    src[GAPX] + ep + t_mgx),
                                 src[GAPY] + ep + t_mgy)
            if y > 0:
                src = f[x, y - 1]
                ep = gapy[ar, cy]
                cell[GAPY] = la(la(la(cell[GAPY], src[MATCH] + ep + t_oy),
                                   src[GAPY] + ep + t_ey),
                                src[GAPX] + ep + t_swy)
            f[x, y] = cell
    end = np.where(rr[None, :],
                   np.stack([(t_ox + t_oy) / 2.0, t_ex, t_ey]),
                   np.stack([t_mm, t_mgx, t_mgy]))
    fin = f[lxs, lys, :, ar].T                                   # (3, B)
    total = np.full(B, LOG_ZERO)
    for s in range(3):
        total = la(total, fin[s] + end[s])
    return total
