"""Device-resident stRPHmm forward-backward.

Parity: stRPHmm_forwardBackward (hmm.c:931-942) with the bit-parallel
emission arithmetic of emissions.c:77-138 — phrased for a device: each
column's cell emissions are one (cells x reads) @ (reads x alleles) matmul
at HIGHEST precision (exact), the per-site ancestor reduction is a masked
min over a small static allele axis, and the forward/backward chain is a
`lax.scan` over column slabs with scatter-max through the merge-column
index maps.

With the default ``maxNotSumTransitions=true`` every quantity in the FB is
an *integer*: profile probs are uint8, substitution/prior penalties uint16,
and the recursion is only + and max (hmm.c:827-929).  The whole device
computation therefore runs in int32 and is **bit-identical** to the float64
host implementation in `phase.rphmm` (which the tests keep as the oracle).
The logaddexp path (maxNotSumTransitions=false) stays on the host.

Shapes are padded to coarse power-of-two buckets so the jitted FB compiles
a handful of variants per run; the per-call prep is one numpy pass over the
columns.  Dispatch policy (`use_device_fb`): on accelerators, HMMs above a
work threshold run here; tiny HMMs (the vast majority — median 3 columns x
4 cells on the 100 kb golden region) stay on the host where dispatch
overhead would dominate.  ``MARGIN_TPU_RPHMM=device|host`` overrides.
"""

from __future__ import annotations

import functools
import os

import numpy as np

# big-but-safe int sentinels: BIG masks invalid alleles out of min
# reductions (BIG + uint16 penalties stays far below 2**31); NEG masks
# padded cells out of max reductions.
BIG = np.int32(1 << 28)
NEG = np.int32(-(1 << 30))

# conservative per-site emission magnitude bound: 2*(maxDepth*255 + 65535)
# + 65535 (see module docstring maths); chains whose total site count could
# overflow int32 forward sums fall back to the host float64 path.
_PER_SITE_BOUND = 2 * (64 * 255 + 65535) + 65535


def _bucket(n: int, lo: int = 4) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def use_device_fb(hmm, include_ancestor: bool) -> bool:
    mode = os.environ.get("MARGIN_TPU_RPHMM", "auto")
    if mode == "host":
        return False
    if not hmm.params.maxNotSumTransitions:
        return False  # logaddexp path: host float64 only
    total_sites = sum(c.length for c in hmm.columns)
    if total_sites * _PER_SITE_BOUND > (1 << 30):
        return False  # int32 forward-sum headroom
    if mode == "device":
        return True
    try:
        import jax
        if jax.default_backend() == "cpu":
            return False
    except Exception:
        return False
    # work estimate: cells x reads across columns (emission matmul area).
    # The win must cover the per-call device round trip (host prep,
    # transfers, readback). The default threshold has not been measured on
    # the GPU; MARGIN_TPU_RPHMM_THRESHOLD overrides it.
    work = sum(len(c.partitions) *
               max(1, c.depth) for c in hmm.columns)
    thresh = int(os.environ.get("MARGIN_TPU_RPHMM_THRESHOLD", 10_000_000))
    return work >= thresh


@functools.lru_cache(maxsize=None)
def _fb_jit(ncol_pad, c_max, d_max, a_max, s_max, as_max, m_max,
            include_ancestor):
    import jax
    import jax.numpy as jnp

    def fb(bits, cell_mask, P, site_off, site_A, site_mask, sub, prior,
           idx_prev, idx_next, em_zero, is_first, is_last, is_pad):
        # per-column emission + forward, one scan step per column
        j_iota = jnp.arange(as_max, dtype=jnp.int32)

        def emission(col):
            (b, cm, p, soff, sA, smask, ssub, sprior, ez) = col
            bf = b.astype(jnp.float32)                       # (C, D)
            # HIGHEST: the sums (<= 64 * 255) must stay exact; the GPU's
            # default float32 dot rounds its inputs to TF32
            hi = jax.lax.Precision.HIGHEST
            s1 = jnp.dot(bf, p, preferred_element_type=jnp.float32,
                         precision=hi)
            s2 = jnp.dot(1.0 - bf, p, preferred_element_type=jnp.float32,
                         precision=hi)
            s1 = s1.astype(jnp.int32)
            s2 = s2.astype(jnp.int32)
            idx = jnp.clip(soff[:, None] + j_iota[None, :], 0, a_max - 1)
            valid_j = j_iota[None, :] < sA[:, None]          # (S, As)
            h1 = jnp.where(valid_j[None], s1[:, idx.reshape(-1)]
                           .reshape(c_max, s_max, as_max), BIG)
            h2 = jnp.where(valid_j[None], s2[:, idx.reshape(-1)]
                           .reshape(c_max, s_max, as_max), BIG)
            if include_ancestor:
                # anc[c,s,a] = min_k h[c,s,k] + sub[s,a,k]; small static k
                anc1 = jnp.full((c_max, s_max, as_max), BIG, jnp.int32)
                anc2 = jnp.full((c_max, s_max, as_max), BIG, jnp.int32)
                for k in range(as_max):
                    anc1 = jnp.minimum(anc1, h1[:, :, k:k + 1]
                                       + ssub[None, :, :, k])
                    anc2 = jnp.minimum(anc2, h2[:, :, k:k + 1]
                                       + ssub[None, :, :, k])
                tot_a = anc1 + anc2 + jnp.where(
                    valid_j, sprior, BIG)[None]              # (C, S, As)
                site_tot = jnp.min(tot_a, axis=2)            # (C, S)
            else:
                site_tot = jnp.min(h1, axis=2) + jnp.min(h2, axis=2)
            site_tot = jnp.where(smask[None], site_tot, 0)
            em = -jnp.sum(site_tot, axis=1)                  # (C,)
            return jnp.where(ez, 0, em).astype(jnp.int32)

        def fwd_step(carry, col):
            (b, cm, p, soff, sA, smask, ssub, sprior,
             iprev, inext, ez, first, last, pad) = col
            em = emission((b, cm, p, soff, sA, smask, ssub, sprior, ez))
            prev = jnp.where(first, 0, carry[iprev])
            fwd = jnp.where(cell_mask_col(cm), prev + em, NEG)
            new_carry = jnp.full((m_max,), NEG, jnp.int32).at[inext].max(fwd)
            new_carry = jnp.where(pad, carry, new_carry)
            return new_carry, (em, fwd, new_carry)

        def bwd_step(carry, col):
            (em, cm, inext, iprev, last, pad) = col
            bwd = jnp.where(last, 0, carry[inext])
            bwd = jnp.where(cell_mask_col(cm), bwd, NEG)
            prop = jnp.where(cell_mask_col(cm), em + bwd, NEG)
            new_carry = jnp.full((m_max,), NEG, jnp.int32).at[iprev].max(prop)
            new_carry = jnp.where(pad, carry, new_carry)
            return new_carry, (bwd, new_carry)

        def cell_mask_col(cm):
            return cm

        init = jnp.full((m_max,), NEG, jnp.int32)
        _, (em, fwd, m_fwd) = jax.lax.scan(
            fwd_step, init,
            (bits, cell_mask, P, site_off, site_A, site_mask, sub, prior,
             idx_prev, idx_next, em_zero, is_first, is_last, is_pad))
        # backward: reverse scan over the same slabs
        rev = lambda x: jnp.flip(x, axis=0)
        _, (bwd_r, m_bwd_r) = jax.lax.scan(
            bwd_step, init,
            (rev(em), rev(cell_mask), rev(idx_next), rev(idx_prev),
             rev(is_last), rev(is_pad)))
        return em, fwd, jnp.flip(bwd_r, 0), m_fwd, jnp.flip(m_bwd_r, 0)

    return jax.jit(fb)


def forward_backward_device(hmm, include_ancestor: bool = True) -> None:
    """Device FB for one RPHmm; fills the same fields the host path does
    (col.emission/forward/backward/total_log_prob, merge.forward/backward,
    hmm.forward_log_prob/backward_log_prob) with bit-identical values."""
    import jax.numpy as jnp

    cols = hmm.columns
    merges = hmm.merges
    ncol = len(cols)
    offsets = hmm.ref.allele_offsets()

    c_max = _bucket(max(len(c.partitions) for c in cols), 8)
    d_max = _bucket(max(1, max(c.depth for c in cols)), 8)
    a_list = [int(offsets[c.ref_start + c.length] - offsets[c.ref_start])
              for c in cols]
    a_max = _bucket(max(1, max(a_list)), 8)
    s_max = _bucket(max(1, max(c.length for c in cols)), 4)
    as_max = _bucket(max((hmm.ref.sites[s].allele_number
                          for c in cols
                          for s in range(c.ref_start,
                                         c.ref_start + c.length)),
                         default=2), 2)
    m_max = _bucket(max((m.size() for m in merges), default=1), 8)
    ncol_pad = _bucket(ncol, 2)

    bits = np.zeros((ncol_pad, c_max, d_max), dtype=np.int8)
    cell_mask = np.zeros((ncol_pad, c_max), dtype=bool)
    P = np.zeros((ncol_pad, d_max, a_max), dtype=np.float32)
    site_off = np.zeros((ncol_pad, s_max), dtype=np.int32)
    site_A = np.zeros((ncol_pad, s_max), dtype=np.int32)
    site_mask = np.zeros((ncol_pad, s_max), dtype=bool)
    sub = np.full((ncol_pad, s_max, as_max, as_max), int(BIG),
                  dtype=np.int32)
    prior = np.zeros((ncol_pad, s_max, as_max), dtype=np.int32)
    idx_prev = np.zeros((ncol_pad, c_max), dtype=np.int32)
    idx_next = np.zeros((ncol_pad, c_max), dtype=np.int32)
    em_zero = np.zeros(ncol_pad, dtype=bool)
    is_first = np.zeros(ncol_pad, dtype=bool)
    is_last = np.zeros(ncol_pad, dtype=bool)
    is_pad = np.zeros(ncol_pad, dtype=bool)
    is_first[0] = True
    is_last[ncol - 1] = True
    is_pad[ncol:] = True

    parts_u64 = [np.array(c.partitions, dtype=np.uint64) for c in cols]
    for ci, col in enumerate(cols):
        C = len(col.partitions)
        d = col.depth
        cell_mask[ci, :C] = True
        if d > 0:
            p64 = parts_u64[ci]
            bits[ci, :C, :d] = (
                (p64[:, None] >> np.arange(d, dtype=np.uint64)[None, :])
                & np.uint64(1)).astype(np.int8)
        a0 = int(offsets[col.ref_start])
        for i, ps in enumerate(col.seqs):
            P[ci, i, :a_list[ci]] = ps.probs[
                a0 - ps.allele_offset:a0 - ps.allele_offset + a_list[ci]]
        em_zero[ci] = (d == 0 or col.length == 0)
        for sj, s in enumerate(range(col.ref_start,
                                     col.ref_start + col.length)):
            site = hmm.ref.sites[s]
            A = site.allele_number
            site_off[ci, sj] = site.allele_offset - a0
            site_A[ci, sj] = A
            site_mask[ci, sj] = True
            sub[ci, sj, :A, :A] = site.substitution_log_probs
            prior[ci, sj, :A] = site.allele_prior_log_probs
        if ci > 0:
            idx_prev[ci, :C] = merges[ci - 1].prev_idx_array(parts_u64[ci])
        if ci < len(merges):
            idx_next[ci, :C] = merges[ci].next_idx_array(parts_u64[ci])

    fb = _fb_jit(ncol_pad, c_max, d_max, a_max, s_max, as_max, m_max,
                 include_ancestor)
    em, fwd, bwd, m_fwd, m_bwd = fb(
        jnp.asarray(bits), jnp.asarray(cell_mask), jnp.asarray(P),
        jnp.asarray(site_off), jnp.asarray(site_A), jnp.asarray(site_mask),
        jnp.asarray(sub), jnp.asarray(prior), jnp.asarray(idx_prev),
        jnp.asarray(idx_next), jnp.asarray(em_zero), jnp.asarray(is_first),
        jnp.asarray(is_last), jnp.asarray(is_pad))
    em = np.asarray(em)
    fwd = np.asarray(fwd)
    bwd = np.asarray(bwd)
    m_fwd = np.asarray(m_fwd)
    m_bwd = np.asarray(m_bwd)

    for ci, col in enumerate(cols):
        C = len(col.partitions)
        col.emission = em[ci, :C].astype(np.float64)
        col.forward = fwd[ci, :C].astype(np.float64)
        col.backward = bwd[ci, :C].astype(np.float64)
        col.total_log_prob = float(np.max(col.forward + col.backward))
        if ci < len(merges):
            M = merges[ci].size()
            merges[ci].forward = m_fwd[ci, :M].astype(np.float64)
            merges[ci].backward = m_bwd[ci + 1, :M].astype(np.float64)
    hmm.forward_log_prob = float(np.max(fwd[ncol - 1,
                                            :len(cols[-1].partitions)]))
    hmm.backward_log_prob = float(np.max(
        em[0, :len(cols[0].partitions)] + bwd[0, :len(cols[0].partitions)]))
