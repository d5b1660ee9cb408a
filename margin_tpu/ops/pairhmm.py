"""Batched 3-state pair-HMM kernels (the device compute path).

The reference's hottest loop (`computeForwardProbability`,
pairwiseAligner.c:849-903) scores one (read-substring, allele) pair at a time
with a scalar anti-diagonal recurrence. Here it is turned inside out:
**the batch is the vector axis**. Thousands of independent pairs are padded
to a common (Lx, Ly) box and a single `lax.scan` walks anti-diagonals d =
0..Lx+Ly; each step updates a (B, W) slab of cells with pure elementwise
ops. The diagonals are short (alleles of ~30-1000 bp) and each step covers
thousands of pairs, so a plain `lax.scan` left to XLA amortizes its
per-step cost. For the phase workload the reference calls this kernel with an
empty anchor list, in which case its band covers the whole DP rectangle
(band_construct with no anchors spans (0,0)..(lX,lY)); the dense rectangle
recurrence below is therefore *exactly* the reference computation, not an
approximation.

States: 0=match, 1=gapX (consumes x), 2=gapY (consumes y)
(stateMachine.c:10-12); transitions/emissions per StateMachine3
(stateMachine.c:562-586); start/end weights stateMachine.c:521-560.

Mixed strands are handled by stacking forward/reverse emission tables on a
leading strand axis and gathering per batch item — one kernel launch per
batch regardless of strand mix.

Run-length-encoded emissions (stateMachine.c:716-752): when repeat tables
are provided, the match emission gains
``2.3025 * repeat_probs[strand_slot(xbase), rep_y, rep_x]``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np

from margin_tpu.ops import logmath
from margin_tpu.utils.lazyjax import jax, jnp, lazy_jit
from margin_tpu.params import StateMachineParams, RepeatSubMatrix, MAXIMUM_REPEAT_LENGTH

MATCH, GAPX, GAPY = 0, 1, 2
LOG_ZERO = -1.0e30  # finite stand-in for -inf: keeps the arithmetic NaN-free

# transition vector layout (StateMachineParams.transition_vector)
T_MM, T_M_FROM_GX, T_M_FROM_GY, T_OPEN_X, T_OPEN_Y, T_EXT_X, T_EXT_Y, T_SW_X, T_SW_Y = range(9)


@dataclass(frozen=True)
class PairHmmTables:
    """Device-resident emission/transition tables, strand-stacked.

    match:  (2, 25)  flattened 5x5 log match emissions per strand
    gap_x:  (2, 5)
    gap_y:  (2, 5)
    trans:  (2, 9)   transition log-probs (layout above)
    repeat: (2, 4*51*51) optional RLE match-emission addend table, flattened
            [slot_base, underlying(rep_x), observed(rep_y)]; already includes
            the 2.3025 natural-log conversion factor.
    """
    match: jnp.ndarray
    gap_x: jnp.ndarray
    gap_y: jnp.ndarray
    trans: jnp.ndarray
    repeat: Optional[jnp.ndarray] = None

    @staticmethod
    def from_params(sm_fwd: StateMachineParams,
                    sm_rev: Optional[StateMachineParams] = None,
                    repeat: Optional[RepeatSubMatrix] = None,
                    dtype=np.float32) -> "PairHmmTables":
        if sm_rev is None:
            sm_rev = sm_fwd.reverse_complement()
        def clamp(a):
            return np.maximum(np.nan_to_num(np.asarray(a, np.float64),
                                            neginf=LOG_ZERO), LOG_ZERO)
        match = np.stack([clamp(sm_fwd.match_probs).ravel(),
                          clamp(sm_rev.match_probs).ravel()])
        gx = np.stack([clamp(sm_fwd.gap_x_probs), clamp(sm_rev.gap_x_probs)])
        gy = np.stack([clamp(sm_fwd.gap_y_probs), clamp(sm_rev.gap_y_probs)])
        tr = np.stack([clamp(sm_fwd.transition_vector()),
                       clamp(sm_rev.transition_vector())])
        rep = None
        np_dtype = np.dtype(dtype)
        if repeat is not None:
            n = MAXIMUM_REPEAT_LENGTH
            # slot for (base b, strand s): s ? b : 3-b  (repeatSubMatrix.c:28-31)
            fwd = repeat.log_probs.reshape(4, n * n)          # slot == base
            rev = repeat.log_probs[::-1].reshape(4, n * n)    # base b -> slot 3-b
            rep = np.asarray(2.3025 * np.stack([fwd, rev]).reshape(2, 4 * n * n),
                             dtype=np_dtype)
        # plain numpy: tables are tiny (the kernels upload them per launch),
        # and worker processes that only relay batches over IPC must not
        # import jax just to hold them
        return PairHmmTables(np.asarray(match, np_dtype),
                             np.asarray(gx, np_dtype),
                             np.asarray(gy, np_dtype),
                             np.asarray(tr, np_dtype), rep)


@dataclass(frozen=True)
class PairBatch:
    """A padded batch of (x, y) sequence pairs.

    xs, ys:   (B, Lx), (B, Ly) uint8 symbol codes (0..4), padded with 4.
    lxs, lys: (B,) int32 true lengths.
    strands:  (B,) int32 — 0 selects the forward-strand tables, 1 reverse.
    rep_x/rep_y: optional (B, L) int32 run lengths (clamped to 50) for RLE.
    ragged_left/right: (B,) bool start/end boundary conditions.
    """
    xs: jnp.ndarray
    ys: jnp.ndarray
    lxs: jnp.ndarray
    lys: jnp.ndarray
    strands: jnp.ndarray
    ragged_left: jnp.ndarray
    ragged_right: jnp.ndarray
    rep_x: Optional[jnp.ndarray] = None
    rep_y: Optional[jnp.ndarray] = None


def _bucket(n: int, quantum: int) -> int:
    """Round up to a shape bucket: multiples of `quantum` up to 4x quantum,
    then powers of two — keeps the set of compiled shapes small."""
    n = max(n, 1)
    if n <= 4 * quantum:
        return ((n + quantum - 1) // quantum) * quantum
    p = 4 * quantum
    while p < n:
        p *= 2
    return p


def make_batch(seq_pairs, strands=None, ragged_left=None, ragged_right=None,
               rep_pairs=None, pad_to=None, bucket: bool = True) -> PairBatch:
    """Host-side batch packing. seq_pairs: list of (x_sym, y_sym) numpy
    arrays. pad_to: optional (Lx, Ly) to stabilize compiled shapes;
    bucket=True quantizes (B, Lx, Ly) so repeated calls reuse compilations
    (padding lanes carry lxs/lys = 0 and are cheap)."""
    b_real = len(seq_pairs)
    lx = max((len(p[0]) for p in seq_pairs), default=1)
    ly = max((len(p[1]) for p in seq_pairs), default=1)
    if pad_to is not None:
        lx, ly = max(lx, pad_to[0]), max(ly, pad_to[1])
    if bucket:
        b = _bucket(b_real, 16)
        lx = _bucket(lx, 16)
        ly = _bucket(ly, 16)
    else:
        b = b_real
    xs = np.full((b, lx), 4, dtype=np.uint8)
    ys = np.full((b, ly), 4, dtype=np.uint8)
    lxs = np.zeros(b, dtype=np.int32)
    lys = np.zeros(b, dtype=np.int32)
    for i, (x, y) in enumerate(seq_pairs):
        xs[i, :len(x)] = x
        ys[i, :len(y)] = y
        lxs[i], lys[i] = len(x), len(y)
    rx = ry = None
    if rep_pairs is not None:
        rx = np.zeros((b, lx), dtype=np.int32)
        ry = np.zeros((b, ly), dtype=np.int32)
        for i, (cx, cy) in enumerate(rep_pairs):
            rx[i, :len(cx)] = np.minimum(cx, MAXIMUM_REPEAT_LENGTH - 1)
            ry[i, :len(cy)] = np.minimum(cy, MAXIMUM_REPEAT_LENGTH - 1)
    def vec(v, default=False):
        out = np.full(b, default, dtype=bool)
        if v is not None:
            out[:b_real] = np.asarray(v, dtype=bool)
        return out
    strands_arr = np.zeros(b, dtype=np.int32)
    if strands is not None:
        strands_arr[:b_real] = np.asarray(strands, dtype=np.int32)
    strands = strands_arr
    return PairBatch(jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(lxs),
                     jnp.asarray(lys), jnp.asarray(strands),
                     jnp.asarray(vec(ragged_left)), jnp.asarray(vec(ragged_right)),
                     None if rx is None else jnp.asarray(rx),
                     None if ry is None else jnp.asarray(ry))


def _log_add3(a, b, c, log_add):
    return log_add(log_add(a, b), c)


def forward_total(tables: PairHmmTables, batch: PairBatch,
                  use_lut: bool = False, unroll: int = 4):
    """Lazy-jit entry for `_forward_total` (see its docstring); registers
    the batch dataclasses as pytrees on first use."""
    _ensure_registered()
    return _forward_total(tables, batch, use_lut=use_lut, unroll=unroll)


@lazy_jit(static_argnames=("use_lut", "unroll"))
def _forward_total(tables: PairHmmTables, batch: PairBatch,
                   use_lut: bool = False, unroll: int = 4):
    """Batched total forward log-probability.

    Parity: computeForwardProbability (pairwiseAligner.c:849-903) called with
    no anchor pairs — the band then covers the full rectangle, so the dense
    recurrence matches cell-for-cell. Returns (B,) log probs.

    Layout: anti-diagonal d scans 0..Lx+Ly. The diagonal slab is (W, B):
    row y holds cell (x=d-y, y), and the BATCH axis rides the 128-wide lane
    dimension (W is a few dozen at most — putting it on lanes wastes ~10x
    in padding; measured 4x throughput from this orientation alone).
    Dependencies:
      gapX(x,y)  <- diag d-1 at row y      (cell (x-1, y))
      gapY(x,y)  <- diag d-1 at row y-1    (cell (x, y-1))
      match(x,y) <- diag d-2 at row y-1    (cell (x-1, y-1))
    The x-symbol consumed at row y of diag d is X[d-1-y]: a contiguous
    window of reversed-X, fetched with one dynamic_slice per step. All
    emission lookups are one-hot select-sums (gather-free — per-step
    gathers were ~15x slower than the whole remaining kernel).
    """
    # all in-kernel values are clamped finite (LOG_ZERO), so the LUT flavor
    # can skip its isinf/isnan guards
    log_add = logmath.log_add_lut_finite if use_lut else logmath.log_add_exact
    B, Lx = batch.xs.shape
    Ly = batch.ys.shape[1]
    W = Ly + 1
    D = Lx + Ly
    dtype = tables.match.dtype

    use_rle = tables.repeat is not None and batch.rep_x is not None

    # per-item tables (gathered once from the tiny strand-stacked tables)
    m_tab = tables.match[batch.strands]      # (B, 25)
    gx_tab = tables.gap_x[batch.strands]     # (B, 5)
    gy_tab = tables.gap_y[batch.strands]     # (B, 5)
    tr = tables.trans[batch.strands]         # (B, 9)
    trc = {i: tr[:, i] for i in range(9)}    # (B,) broadcastable over (W,B)

    y_iota = jax.lax.broadcasted_iota(jnp.int32, (W, B), 0)
    lys_r = batch.lys[None, :]               # (1, B)
    lxs_r = batch.lxs[None, :]

    # y-symbols per row: cY at row y is Y[y-1]; row 0 -> N(4)
    cy = jnp.concatenate([jnp.full((B, 1), 4, jnp.uint8), batch.ys],
                         axis=1).astype(jnp.int32).T  # (W, B)
    e_gy = jnp.take_along_axis(gy_tab, cy.T, axis=1).T  # (W, B), once
    # m_rows[i]: match emission at row y if cx == i  (5, W, B)
    cy1h = [(cy == j) for j in range(5)]
    m_rows = jnp.stack([
        sum(jnp.where(cy1h[j], m_tab[None, :, i * 5 + j], 0.0)
            for j in range(5))
        for i in range(5)])  # (5, W, B)
    gx_rows = [gx_tab[None, :, i] for i in range(5)]  # (1,B) each

    # Padded-reversed X for the sliding window: the x-symbol consumed at row
    # y of diag d is X[d-1-y]; with xpad = [N*Ly, reverse(X), N*W] that is
    # xpad[Lx+Ly-d+y] — one dynamic_slice per scan step. (L, B) layout.
    xpad = jnp.concatenate([jnp.full((B, Ly), 4, jnp.uint8),
                            jnp.flip(batch.xs, axis=1),
                            jnp.full((B, W), 4, jnp.uint8)],
                           axis=1).astype(jnp.int32).T  # (Lx+Ly+W, B)
    if use_rle:
        ry = jnp.concatenate([jnp.zeros((B, 1), jnp.int32), batch.rep_y],
                             axis=1).T  # (W, B)
        rxpad = jnp.concatenate([jnp.zeros((B, Ly), jnp.int32),
                                 jnp.flip(batch.rep_x, axis=1),
                                 jnp.zeros((B, W), jnp.int32)], axis=1).T
        rep_tab = tables.repeat[batch.strands]  # (B, 4*51*51)

    neg = jnp.asarray(LOG_ZERO, dtype)

    # start cell (0,0) at diag 0, row 0 (stateMachine.c:521-530)
    rl = batch.ragged_left[None, :]
    row0 = (y_iota == 0)
    m0 = jnp.where(row0 & ~rl, 0.0, neg).astype(dtype)
    g0 = jnp.where(row0 & rl, 0.0, neg).astype(dtype)
    diag0 = (m0, g0, g0)  # (match, gapX, gapY), each (W, B)

    def shift_row(a):  # row y <- row y-1 (prepend LOG_ZERO row)
        return jnp.concatenate([jnp.full((1, B), neg, dtype), a[:-1]], axis=0)

    def step(carry, d):
        (p1m, p1x, p1y), (p2m, p2x, p2y), result = carry
        cx = jax.lax.dynamic_slice_in_dim(xpad, Lx + Ly - d, W, axis=0)
        cx1h = [(cx == i) for i in range(5)]
        # gather-free emissions: one-hot select over the 5-symbol alphabet
        e_m = sum(jnp.where(cx1h[i], m_rows[i], 0.0) for i in range(5))
        e_gx = sum(jnp.where(cx1h[i], gx_rows[i], 0.0) for i in range(5))
        if use_rle:
            rxw = jax.lax.dynamic_slice_in_dim(rxpad, Lx + Ly - d, W, axis=0)
            base = jnp.where(cx >= 4, 0, cx)  # N -> A (repeatSubMatrix.c:16-27)
            n = MAXIMUM_REPEAT_LENGTH
            rep_idx = base * (n * n) + rxw * n + ry
            e_m = e_m + jnp.take_along_axis(rep_tab, rep_idx.T, axis=1).T

        s2m, s2x, s2y = shift_row(p2m), shift_row(p2x), shift_row(p2y)
        u1m, u1x, u1y = shift_row(p1m), shift_row(p1x), shift_row(p1y)

        new_gx = e_gx + _log_add3(p1m + trc[T_OPEN_X], p1x + trc[T_EXT_X],
                                  p1y + trc[T_SW_X], log_add)
        new_m = e_m + _log_add3(s2m + trc[T_MM], s2x + trc[T_M_FROM_GX],
                                s2y + trc[T_M_FROM_GY], log_add)
        new_gy = e_gy + _log_add3(u1m + trc[T_OPEN_Y], u1y + trc[T_EXT_Y],
                                  u1x + trc[T_SW_Y], log_add)

        x_pos = d - y_iota
        valid = (y_iota <= lys_r) & (x_pos >= 0) & (x_pos <= lxs_r)
        # clamp accumulated underflow to the finite LOG_ZERO
        new_m = jnp.maximum(jnp.where(valid, new_m, neg), neg)
        new_gx = jnp.maximum(jnp.where(valid, new_gx, neg), neg)
        new_gy = jnp.maximum(jnp.where(valid, new_gy, neg), neg)

        # harvest total when d == lx+ly at row y=ly (masked reduce: exactly
        # one row matches lys)
        final_row = (y_iota == lys_r)
        fm = jnp.sum(jnp.where(final_row, new_m, 0.0), axis=0)  # (B,)
        fx = jnp.sum(jnp.where(final_row, new_gx, 0.0), axis=0)
        fy = jnp.sum(jnp.where(final_row, new_gy, 0.0), axis=0)
        rr = batch.ragged_right
        tot = log_add(
            log_add(
                fm + jnp.where(rr, (trc[T_OPEN_X] + trc[T_OPEN_Y]) / 2.0,
                               trc[T_MM]),
                fx + jnp.where(rr, trc[T_EXT_X], trc[T_M_FROM_GX])),
            fy + jnp.where(rr, trc[T_EXT_Y], trc[T_M_FROM_GY]))
        result = jnp.where(d == batch.lxs + batch.lys, tot, result)
        return ((new_m, new_gx, new_gy), (p1m, p1x, p1y), result), None

    negdiag = (jnp.full((W, B), neg, dtype),) * 3
    init = (diag0, negdiag, jnp.full((B,), neg, dtype))
    (_, _, result), _ = jax.lax.scan(step, init, jnp.arange(1, D + 1),
                                     unroll=unroll)
    # trivial case lx+ly == 0 returns LOG_ONE (pairwiseAligner.c:860-862)
    result = jnp.where(batch.lxs + batch.lys == 0, 0.0, result)
    return result


_REGISTERED = False


def _ensure_registered():
    """Pytree-register the batch dataclasses on first device use (deferred
    so worker processes that only ship batches over IPC never import jax)."""
    global _REGISTERED
    if _REGISTERED:
        return
    import jax as _jax
    _jax.tree_util.register_dataclass(
        PairHmmTables,
        data_fields=["match", "gap_x", "gap_y", "trans", "repeat"],
        meta_fields=[])
    _jax.tree_util.register_dataclass(
        PairBatch,
        data_fields=["xs", "ys", "lxs", "lys", "strands", "ragged_left",
                     "ragged_right", "rep_x", "rep_y"],
        meta_fields=[])
    _REGISTERED = True
