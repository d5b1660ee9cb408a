"""Read-partition HMM (stRPHmm): columns of read-set bipartitions over
heterozygous sites, with forward-backward, pruning, merge algebra and
traceback.

Parity: impl/hmm.c, impl/column.c, impl/mergeColumn.c, impl/partitions.c,
impl/emissions.c, impl/coordination.c.

Design: the reference stores cells in linked lists and computes emissions
with bit-plane popcounts (emissions.c:77-138). Here a column's cells are a
uint64 partition vector and the emission for *all* cells of a column is one
masked matrix product: cells-x-reads boolean matrix @ reads-x-alleles uint8
profile matrix — the same integer arithmetic the popcounts implement, as
one matrix product. All probabilities are float64; with the default
maxNotSumTransitions=true the FB recursion is exact (+ and max only), so
results are bit-identical to the C code.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from margin_tpu.params import PhaseParams, MAX_READ_PARTITIONING_DEPTH
from margin_tpu.phase.bubbles import ProfileSeq, Reference

LOG_ZERO = -np.inf

_counter = itertools.count()


def make_accept_mask(depth: int) -> int:
    """partitions.c:13-19."""
    return (1 << depth) - 1 if depth < 64 else 0xFFFFFFFFFFFFFFFF


def merge_partitions(p1: int, p2: int, depth1: int, depth2: int) -> int:
    """partitions.c:21-28."""
    assert depth1 + depth2 <= MAX_READ_PARTITIONING_DEPTH
    return ((p2 << depth1) | p1) & 0xFFFFFFFFFFFFFFFF


def invert_partition(p: int, depth: int) -> int:
    """partitions.c:37-42."""
    return make_accept_mask(depth) & ~p & 0xFFFFFFFFFFFFFFFF


class Column:
    """stRPColumn: run of sites sharing a constant read set (column.c)."""

    __slots__ = ("ref_start", "length", "seqs", "partitions", "forward",
                 "backward", "emission", "total_log_prob")

    def __init__(self, ref_start: int, length: int, seqs: List[ProfileSeq],
                 partitions: List[int]):
        self.ref_start = ref_start
        self.length = length
        self.seqs = seqs  # bit i of a partition <-> seqs[i]
        self.partitions = list(partitions)
        self.forward: Optional[np.ndarray] = None
        self.backward: Optional[np.ndarray] = None
        self.emission: Optional[np.ndarray] = None
        self.total_log_prob = LOG_ZERO

    @property
    def depth(self) -> int:
        return len(self.seqs)

    def posterior(self) -> np.ndarray:
        p = np.exp(self.forward + self.backward - self.total_log_prob)
        return np.minimum(p, 1.0)


class MergeColumn:
    """stRPMergeColumn: maps partitions between adjacent read sets."""

    __slots__ = ("mask_from", "mask_to", "from_parts", "to_parts",
                 "from_index", "to_index", "forward", "backward",
                 "_from_sorted", "_from_order", "_to_sorted", "_to_order")

    def __init__(self, mask_from: int, mask_to: int):
        self.mask_from = mask_from
        self.mask_to = mask_to
        self.from_parts: List[int] = []
        self.to_parts: List[int] = []
        self.from_index: Dict[int, int] = {}
        self.to_index: Dict[int, int] = {}
        self.forward: Optional[np.ndarray] = None
        self.backward: Optional[np.ndarray] = None
        self._from_sorted = None
        self._from_order = None
        self._to_sorted = None
        self._to_order = None

    def add_cell(self, from_p: int, to_p: int):
        assert from_p not in self.from_index
        assert to_p not in self.to_index
        self.from_index[from_p] = len(self.from_parts)
        self.to_index[to_p] = len(self.to_parts)
        self.from_parts.append(from_p)
        self.to_parts.append(to_p)
        self._from_sorted = None
        self._to_sorted = None

    def set_cells(self, from_parts: List[int], to_parts: List[int]):
        """Bulk add_cell."""
        self.from_parts = from_parts
        self.to_parts = to_parts
        self.from_index = {p: i for i, p in enumerate(from_parts)}
        self.to_index = {p: i for i, p in enumerate(to_parts)}
        assert len(self.from_index) == len(from_parts)
        assert len(self.to_index) == len(to_parts)
        self._from_sorted = self._to_sorted = None

    def size(self) -> int:
        return len(self.from_parts)

    def next_cell_idx(self, partition: int) -> Optional[int]:
        """Merge cell this column-cell feeds into (mergeColumn.c:63-70)."""
        return self.from_index.get(partition & self.mask_from)

    def prev_cell_idx(self, partition: int) -> Optional[int]:
        """Merge cell this column-cell feeds from (mergeColumn.c:72-79)."""
        return self.to_index.get(partition & self.mask_to)

    def next_idx_array(self, parts_u64: np.ndarray) -> np.ndarray:
        """Vectorized next_cell_idx over a partition array (all present)."""
        if self._from_sorted is None:
            vals = np.array(self.from_parts, dtype=np.uint64)
            self._from_order = np.argsort(vals, kind="stable")
            self._from_sorted = vals[self._from_order]
        masked = parts_u64 & np.uint64(self.mask_from)
        return self._from_order[np.searchsorted(self._from_sorted, masked)]

    def prev_idx_array(self, parts_u64: np.ndarray) -> np.ndarray:
        """Vectorized prev_cell_idx over a partition array (all present)."""
        if self._to_sorted is None:
            vals = np.array(self.to_parts, dtype=np.uint64)
            self._to_order = np.argsort(vals, kind="stable")
            self._to_sorted = vals[self._to_order]
        masked = parts_u64 & np.uint64(self.mask_to)
        return self._to_order[np.searchsorted(self._to_sorted, masked)]

    def next_idx_or_m1(self, parts_u64: np.ndarray) -> np.ndarray:
        """Vectorized next_cell_idx; -1 where the masked partition has no
        merge cell (the post-prune linkage test of hmm.c:1021-1047)."""
        if self._from_sorted is None:
            vals = np.array(self.from_parts, dtype=np.uint64)
            self._from_order = np.argsort(vals, kind="stable")
            self._from_sorted = vals[self._from_order]
        if len(self._from_sorted) == 0:
            return np.full(len(parts_u64), -1, dtype=np.int64)
        masked = parts_u64 & np.uint64(self.mask_from)
        pos = np.searchsorted(self._from_sorted, masked)
        pos_c = np.minimum(pos, len(self._from_sorted) - 1)
        hit = self._from_sorted[pos_c] == masked
        return np.where(hit, self._from_order[pos_c], -1)

    def prev_idx_or_m1(self, parts_u64: np.ndarray) -> np.ndarray:
        """Vectorized prev_cell_idx; -1 where missing."""
        if self._to_sorted is None:
            vals = np.array(self.to_parts, dtype=np.uint64)
            self._to_order = np.argsort(vals, kind="stable")
            self._to_sorted = vals[self._to_order]
        if len(self._to_sorted) == 0:
            return np.full(len(parts_u64), -1, dtype=np.int64)
        masked = parts_u64 & np.uint64(self.mask_to)
        pos = np.searchsorted(self._to_sorted, masked)
        pos_c = np.minimum(pos, len(self._to_sorted) - 1)
        hit = self._to_sorted[pos_c] == masked
        return np.where(hit, self._to_order[pos_c], -1)


class RPHmm:
    """stRPHmm: alternating columns and merge columns."""

    def __init__(self, ref: Reference, ref_start: int, ref_length: int,
                 profile_seqs: List[ProfileSeq], columns: List[Column],
                 merges: List[MergeColumn], params: PhaseParams):
        self.ref = ref
        self.ref_start = ref_start
        self.ref_length = ref_length
        self.profile_seqs = profile_seqs
        self.columns = columns
        self.merges = merges  # len == len(columns) - 1
        self.params = params
        self.forward_log_prob = LOG_ZERO
        self.backward_log_prob = LOG_ZERO
        self._uid = next(_counter)

    # -- constructors --------------------------------------------------------

    @staticmethod
    def from_profile_seq(ps: ProfileSeq, ref: Reference, params: PhaseParams) -> "RPHmm":
        """stRPHmm_construct (hmm.c:97-133): single column, cells {1, 0}."""
        col = Column(ps.ref_start, ps.length, [ps], [1, 0])
        return RPHmm(ref, ps.ref_start, ps.length, [ps], [col], [], params)

    def sort_key(self):
        """stRPHmm_cmpFn (hmm.c:67-95): refStart asc, length desc, first
        read id, then creation order (stands in for pointer comparison)."""
        first_id = self.profile_seqs[0].read_id if self.profile_seqs else ""
        return (self.ref_start, -self.ref_length, first_id, self._uid)

    def overlaps(self, other: "RPHmm") -> bool:
        if self.ref_start > other.ref_start:
            return other.overlaps(self)
        return self.ref_start + self.ref_length > other.ref_start

    # -- fuse / align / cross product ---------------------------------------

    @staticmethod
    def fuse(left: "RPHmm", right: "RPHmm") -> "RPHmm":
        """stRPHmm_fuse (hmm.c:283-372)."""
        assert left.ref_start < right.ref_start
        assert left.ref_start + left.ref_length <= right.ref_start
        columns = list(left.columns)
        merges = list(left.merges)
        m = MergeColumn(0, 0)
        m.add_cell(0, 0)
        merges.append(m)
        gap = right.ref_start - (left.ref_start + left.ref_length)
        if gap > 0:
            columns.append(Column(left.ref_start + left.ref_length, gap, [], [0]))
            m2 = MergeColumn(0, 0)
            m2.add_cell(0, 0)
            merges.append(m2)
        columns.extend(right.columns)
        merges.extend(right.merges)
        return RPHmm(left.ref, left.ref_start,
                     right.ref_start + right.ref_length - left.ref_start,
                     left.profile_seqs + right.profile_seqs, columns, merges,
                     left.params)

    def _pad_prefix(self, new_start: int):
        """Empty prefix column (hmm.c:396-424)."""
        col = Column(new_start, self.ref_start - new_start, [], [0])
        m = MergeColumn(0, 0)
        m.add_cell(0, 0)
        self.columns.insert(0, col)
        self.merges.insert(0, m)
        self.ref_length += self.ref_start - new_start
        self.ref_start = new_start

    def _pad_suffix(self, new_length: int):
        """Empty suffix column (hmm.c:435-462)."""
        last = self.columns[-1]
        start = last.ref_start + last.length
        col = Column(start, self.ref_start + new_length - start, [], [0])
        m = MergeColumn(0, 0)
        m.add_cell(0, 0)
        self.columns.append(col)
        self.merges.append(m)
        self.ref_length = new_length

    def _split_column(self, idx: int, first_half_length: int):
        """stRPColumn_split (column.c:70-124): identity merge column between
        the halves."""
        col = self.columns[idx]
        assert 0 < first_half_length < col.length
        rcol = Column(col.ref_start + first_half_length,
                      col.length - first_half_length, list(col.seqs),
                      list(col.partitions))
        mask = make_accept_mask(col.depth)
        m = MergeColumn(mask, mask)
        for p in col.partitions:
            m.add_cell(p, p)
        col.length = first_half_length
        self.columns.insert(idx + 1, rcol)
        self.merges.insert(idx, m)

    def _column_index_at(self, site: int) -> int:
        """getColumn (hmm.c): index of the column containing `site`."""
        for i, col in enumerate(self.columns):
            if col.ref_start <= site < col.ref_start + col.length:
                return i
        raise ValueError(f"site {site} outside hmm "
                         f"[{self.ref_start}, {self.ref_start + self.ref_length})")

    def split(self, split_point: int) -> "RPHmm":
        """stRPHmm_split (hmm.c:1223-1300): split in place at split_point,
        returning the suffix hmm (this hmm becomes the prefix). Profile
        seqs spanning the split end up in both."""
        assert self.ref_start < split_point < self.ref_start + self.ref_length
        idx = self._column_index_at(split_point)
        if split_point > self.columns[idx].ref_start:
            self._split_column(idx, split_point - self.columns[idx].ref_start)
            idx += 1
        assert self.columns[idx].ref_start == split_point
        suffix_seqs = [ps for ps in self.profile_seqs
                       if ps.ref_start + ps.length > split_point]
        prefix_seqs = [ps for ps in self.profile_seqs
                       if ps.ref_start < split_point]
        suffix = RPHmm(self.ref, split_point,
                       self.ref_start + self.ref_length - split_point,
                       suffix_seqs, self.columns[idx:], self.merges[idx:],
                       self.params)
        self.ref_length = split_point - self.ref_start
        self.profile_seqs = prefix_seqs
        self.columns = self.columns[:idx]
        self.merges = self.merges[:idx - 1]
        assert self.ref_length > 0 and suffix.ref_length > 0
        return suffix

    def _sites_linkage_is_well_supported(self, left_site: int,
                                         right_site: int) -> bool:
        """sitesLinkageIsWellSupported (hmm.c:1302-1320): enough reads span
        both sites."""
        left = self.columns[self._column_index_at(left_site)]
        right = self.columns[self._column_index_at(right_site)]
        common = ({id(ps) for ps in left.seqs}
                  & {id(ps) for ps in right.seqs})
        return len(common) >= \
            self.params.minReadCoverageToSupportPhasingBetweenHeterozygousSites

    @staticmethod
    def align_columns(h1: "RPHmm", h2: "RPHmm"):
        """stRPHmm_alignColumns (hmm.c:374-507), in place."""
        assert h1.overlaps(h2)
        if h1.ref_start != h2.ref_start:
            if h1.ref_start < h2.ref_start:
                h2._pad_prefix(h1.ref_start)
            else:
                h1._pad_prefix(h2.ref_start)
        if h1.ref_length != h2.ref_length:
            if h1.ref_length > h2.ref_length:
                h2._pad_suffix(h1.ref_length)
            else:
                h1._pad_suffix(h2.ref_length)
        i = 0
        while i < len(h1.columns) or i < len(h2.columns):
            c1, c2 = h1.columns[i], h2.columns[i]
            assert c1.ref_start == c2.ref_start
            if c1.length > c2.length:
                h1._split_column(i, c2.length)
            elif c2.length > c1.length:
                h2._split_column(i, c1.length)
            i += 1
        assert len(h1.columns) == len(h2.columns)

    @staticmethod
    def cross_product(h1: "RPHmm", h2: "RPHmm") -> "RPHmm":
        """stRPHmm_createCrossProductOfTwoAlignedHmm (hmm.c:534-750)."""
        assert h1.ref_start == h2.ref_start and h1.ref_length == h2.ref_length
        assert len(h1.columns) == len(h2.columns)
        params = h1.params
        inverted = params.includeInvertedPartitions
        columns: List[Column] = []
        merges: List[MergeColumn] = []
        for ci, (c1, c2) in enumerate(zip(h1.columns, h2.columns)):
            depth = c1.depth + c2.depth
            # vectorized pairwise merge, p1-major (== the reference's
            # nested-loop order); dedup + invert interleaving in plain ints
            p1a = np.array(c1.partitions, dtype=np.uint64)
            p2a = np.array(c2.partitions, dtype=np.uint64)
            mm = ((p2a[None, :] << np.uint64(c1.depth))
                  | p1a[:, None]).ravel()
            if inverted:
                # the reference loop interleaves each new cell with its
                # inverse and skips already-seen cells; since seen-pairs
                # always come as {p, ~p}, an order-preserving dedup of the
                # interleaved stream reproduces it exactly
                if depth > 0:
                    full = np.uint64(make_accept_mask(depth))
                    inter = np.empty(2 * mm.size, dtype=np.uint64)
                    inter[0::2] = mm
                    inter[1::2] = full & ~mm
                else:
                    inter = mm
                _, first = np.unique(inter, return_index=True)
                parts = inter[np.sort(first)].tolist()
            else:
                parts = mm.tolist()
            columns.append(Column(c1.ref_start, c1.length, c1.seqs + c2.seqs, parts))
            if ci < len(h1.columns) - 1:
                m1, m2 = h1.merges[ci], h2.merges[ci]
                d1p, d2p = c1.depth, c2.depth
                d1n, d2n = h1.columns[ci + 1].depth, h2.columns[ci + 1].depth
                mask_from = merge_partitions(m1.mask_from, m2.mask_from, d1p, d2p)
                mask_to = merge_partitions(m1.mask_to, m2.mask_to, d1n, d2n)
                m = MergeColumn(mask_from, mask_to)
                f1a = np.array(m1.from_parts, dtype=np.uint64)
                t1a = np.array(m1.to_parts, dtype=np.uint64)
                f2a = np.array(m2.from_parts, dtype=np.uint64)
                t2a = np.array(m2.to_parts, dtype=np.uint64)
                fps = ((f2a[None, :] << np.uint64(d1p))
                       | f1a[:, None]).ravel()
                tps = ((t2a[None, :] << np.uint64(d1n))
                       | t1a[:, None]).ravel()
                if inverted:
                    if mask_from != 0:
                        ffm = np.uint64(mask_from
                                        & make_accept_mask(d1p + d2p))
                        ttm = np.uint64(mask_to
                                        & make_accept_mask(d1n + d2n))
                        inter_f = np.empty(2 * fps.size, dtype=np.uint64)
                        inter_t = np.empty(2 * tps.size, dtype=np.uint64)
                        inter_f[0::2] = fps
                        inter_f[1::2] = ffm & ~fps
                        inter_t[0::2] = tps
                        inter_t[1::2] = ttm & ~tps
                    else:
                        inter_f, inter_t = fps, tps
                    _, first = np.unique(inter_f, return_index=True)
                    keep = np.sort(first)
                    m.set_cells(inter_f[keep].tolist(),
                                inter_t[keep].tolist())
                else:
                    m.set_cells(fps.tolist(), tps.tolist())
                merges.append(m)
        return RPHmm(h1.ref, h1.ref_start, h1.ref_length,
                     h1.profile_seqs + h2.profile_seqs, columns, merges, params)

    # -- emissions -----------------------------------------------------------

    def _column_emissions(self, col: Column, include_ancestor: bool) -> np.ndarray:
        """emissionLogProbability for every cell of a column at once
        (emissions.c:125-240). Exact integer arithmetic."""
        n_cells = len(col.partitions)
        if col.depth == 0 or col.length == 0:
            return np.zeros(n_cells)
        parts = np.array(col.partitions, dtype=np.uint64)
        d = col.depth
        bits = ((parts[:, None] >> np.arange(d, dtype=np.uint64)[None, :]) & np.uint64(1))
        m = bits.astype(np.int64)  # (C, D) membership of read i in hap1
        # profile matrix over the column's sites
        offsets = self.ref.allele_offsets()
        a0 = int(offsets[col.ref_start])
        a1 = int(offsets[col.ref_start + col.length])
        P = np.zeros((d, a1 - a0), dtype=np.int64)
        for i, ps in enumerate(col.seqs):
            P[i] = ps.probs[a0 - ps.allele_offset:a1 - ps.allele_offset]
        s1 = m @ P         # (C, A) -log probs of hap1 partitions
        s2 = (1 - m) @ P   # complement partition
        total = np.zeros(n_cells, dtype=np.int64)
        for s in range(col.ref_start, col.ref_start + col.length):
            site = self.ref.sites[s]
            off = site.allele_offset - a0
            a = site.allele_number
            h1 = s1[:, off:off + a]
            h2 = s2[:, off:off + a]
            if not include_ancestor:
                total += h1.min(axis=1) + h2.min(axis=1)
            else:
                sub = site.substitution_log_probs.astype(np.int64)  # (A, A)
                anc1 = (h1[:, None, :] + sub[None, :, :]).min(axis=2)  # (C, A)
                anc2 = (h2[:, None, :] + sub[None, :, :]).min(axis=2)
                prior = site.allele_prior_log_probs.astype(np.int64)[None, :]
                total += (anc1 + anc2 + prior).min(axis=1)
        return -total.astype(np.float64)

    # -- forward-backward ----------------------------------------------------

    def forward_backward(self, include_ancestor: bool = True):
        """stRPHmm_forwardBackward (hmm.c:931-942).

        Large HMMs on accelerators route to the bit-identical int32 device
        kernel in `phase.rphmm_device` (maxNotSum path only); this float64
        numpy implementation is the oracle and the small-problem path."""
        from margin_tpu.phase import rphmm_device
        if rphmm_device.use_device_fb(self, include_ancestor):
            return rphmm_device.forward_backward_device(self, include_ancestor)
        max_not_sum = self.params.maxNotSumTransitions

        def reduce_into(dst, dst_idx, vals):
            if max_not_sum:
                np.maximum.at(dst, dst_idx, vals)
            else:
                for i, v in zip(dst_idx, vals):
                    dst[i] = np.logaddexp(dst[i], v)

        self.forward_log_prob = LOG_ZERO
        self.backward_log_prob = LOG_ZERO

        # per-column vectorized merge index maps, shared by both passes
        parts_u64 = [np.array(c.partitions, dtype=np.uint64)
                     for c in self.columns]
        idx_prev = [None] * len(self.columns)  # merges[ci-1] <- col ci
        idx_next = [None] * len(self.columns)  # merges[ci]   <- col ci
        for ci in range(len(self.columns)):
            if ci > 0:
                idx_prev[ci] = self.merges[ci - 1].prev_idx_array(parts_u64[ci])
            if ci < len(self.merges):
                idx_next[ci] = self.merges[ci].next_idx_array(parts_u64[ci])

        # forward (hmm.c:827-879)
        for ci, col in enumerate(self.columns):
            emission = self._column_emissions(col, include_ancestor)
            col.emission = emission
            if ci == 0:
                fwd = emission.copy()
            else:
                fwd = self.merges[ci - 1].forward[idx_prev[ci]] + emission
            col.forward = fwd
            if ci < len(self.merges):
                m = self.merges[ci]
                m.forward = np.full(m.size(), LOG_ZERO)
                reduce_into(m.forward, idx_next[ci], fwd)
            else:
                self.forward_log_prob = (np.max(fwd) if max_not_sum
                                         else _lse(fwd))

        # backward (hmm.c:881-929)
        for ci in range(len(self.columns) - 1, -1, -1):
            col = self.columns[ci]
            if ci < len(self.merges):
                bwd = self.merges[ci].backward[idx_next[ci]]
            else:
                bwd = np.zeros(len(col.partitions))
            col.backward = bwd
            propagate = col.emission + bwd
            if ci > 0:
                m = self.merges[ci - 1]
                m.backward = np.full(m.size(), LOG_ZERO)
                reduce_into(m.backward, idx_prev[ci], propagate)
            else:
                self.backward_log_prob = (np.max(propagate) if max_not_sum
                                          else _lse(propagate))
            tot = col.forward + col.backward
            col.total_log_prob = np.max(tot) if max_not_sum else _lse(tot)

    # -- pruning -------------------------------------------------------------

    def prune(self):
        """stRPHmm_prune (hmm.c:1160-1163): forwards then backwards."""
        self._prune_pass(forwards=True)
        self._prune_pass(forwards=False)

    def _keep_count(self, sorted_post: np.ndarray) -> int:
        """Cells kept from a descending-posterior list (hmm.c:1065-1068)."""
        p = self.params
        n = len(sorted_post)
        while (n > p.minPartitionsInAColumn
               and (n > p.maxPartitionsInAColumn
                    or sorted_post[n - 1] < p.minPosteriorProbabilityForPartition)):
            n -= 1
        return n

    def _prune_pass(self, forwards: bool):
        order_cols = (range(len(self.columns)) if forwards
                      else range(len(self.columns) - 1, -1, -1))
        prev_merge = None  # merge column crossed to reach this column
        for ci in order_cols:
            col = self.columns[ci]
            parts = np.array(col.partitions, dtype=np.uint64)
            # keep cells that still link backwards (getLinkedCells, hmm.c:1021-1047)
            if prev_merge is not None:
                linkv = (prev_merge.prev_idx_or_m1(parts) if forwards
                         else prev_merge.next_idx_or_m1(parts))
                sel = np.nonzero(linkv >= 0)[0]
            else:
                sel = np.arange(len(parts))
            kept_post = col.posterior()[sel]
            order = np.argsort(-kept_post, kind="stable")
            sel = sel[order]
            kept_post = kept_post[order]
            if forwards:
                n = self._keep_count(kept_post)
                sel = sel[:n]
                kept_post = kept_post[:n]
            # relink in sorted order, keep fb arrays consistent
            col.partitions = parts[sel].tolist()
            col.forward = col.forward[sel]
            col.backward = col.backward[sel]
            col.emission = col.emission[sel]

            # prune the next merge column (hmm.c:1084-1101)
            m = None
            if forwards and ci < len(self.merges):
                m = self.merges[ci]
            elif not forwards and ci > 0:
                m = self.merges[ci - 1]
            if m is None:
                prev_merge = None
                continue
            kept_parts = np.array(col.partitions, dtype=np.uint64)
            links = (m.next_idx_or_m1(kept_parts) if forwards
                     else m.prev_idx_or_m1(kept_parts))
            assert (links >= 0).all()
            # dedup preserving first-occurrence (cell-posterior) order
            _, first = np.unique(links, return_index=True)
            chosen = links[np.sort(first)].tolist()
            if forwards:
                # sort chosen merge cells by posterior desc and trim
                total = (self.columns[ci + 1].total_log_prob if True else 0.0)
                mpost = np.minimum(np.exp(m.forward[chosen] + m.backward[chosen]
                                          - self.columns[ci + 1].total_log_prob), 1.0)
                order = np.argsort(-mpost, kind="stable")
                chosen = [chosen[i] for i in order]
                mpost = mpost[order]
                n = self._keep_count(mpost)
                chosen = chosen[:n]
            # filter merge column to chosen cells
            sel = np.array(sorted(chosen), dtype=np.int64)
            m.from_parts = [m.from_parts[i] for i in sel]
            m.to_parts = [m.to_parts[i] for i in sel]
            m.from_index = {p: i for i, p in enumerate(m.from_parts)}
            m.to_index = {p: i for i, p in enumerate(m.to_parts)}
            m._from_sorted = m._to_sorted = None  # drop idx-array caches
            m.forward = m.forward[sel]
            m.backward = m.backward[sel]
            prev_merge = m

    # -- traceback -----------------------------------------------------------

    def forward_traceback(self) -> List[int]:
        """stRPHmm_forwardTraceBack (hmm.c:165-219): returns one partition
        per column (most probable forward path)."""
        path = []
        ci = len(self.columns) - 1
        col = self.columns[ci]
        best = int(np.argmax(col.forward))  # first max wins, like the C scan
        path.append(col.partitions[best])
        while ci > 0:
            m = self.merges[ci - 1]
            mcell = m.prev_cell_idx(col.partitions[best])
            ci -= 1
            col = self.columns[ci]
            links = m.next_idx_or_m1(
                np.array(col.partitions, dtype=np.uint64))
            cand = np.where(links == mcell, col.forward, LOG_ZERO)
            best = int(np.argmax(cand))  # first strict max, like the C scan
            assert links[best] == mcell
            path.append(col.partitions[best])
        path.reverse()
        return path


def _lse(a: np.ndarray) -> float:
    m = np.max(a)
    if np.isneginf(m):
        return LOG_ZERO
    return float(m + np.log(np.sum(np.exp(a - m))))


# -- coordination (tiling paths, merging; coordination.c) --------------------

def get_tiling_paths(hmms: List[RPHmm]) -> List[List[RPHmm]]:
    """getTilingPaths (coordination.c:186-222): partition sorted hmms into
    maximal non-overlapping chains."""
    remaining = sorted(hmms, key=lambda h: h.sort_key())
    paths = []
    while remaining:
        path = [remaining[0]]
        used = {0}
        cur = remaining[0]
        i = 1
        while i < len(remaining):
            h = remaining[i]
            if cur.ref_start + cur.ref_length <= h.ref_start:
                path.append(h)
                used.add(i)
                cur = h
            i += 1
        remaining = [h for i, h in enumerate(remaining) if i not in used]
        paths.append(path)
    return paths


def fuse_tiling_path(path: List[RPHmm]) -> RPHmm:
    """fuseTilingPath (coordination.c:244-261)."""
    hmm = path[-1]
    for left in reversed(path[:-1]):
        hmm = RPHmm.fuse(left, hmm)
    return hmm


def get_overlapping_components(tp1: List[RPHmm], tp2: List[RPHmm]):
    """getOverlappingComponents (coordination.c:69-184): transitive closure
    of reference overlap between two non-overlapping-within-themselves
    paths. Returns list of components (each a list of hmms)."""
    comp_of: Dict[int, list] = {}
    components: List[list] = []

    def make_component(h):
        c = [h]
        components.append(c)
        comp_of[id(h)] = c
        return c

    j = 0
    for h1 in tp1:
        component = None
        k = 0
        while j + k < len(tp2):
            h2 = tp2[j + k]
            if h1.overlaps(h2):
                k += 1
                if component is None:
                    component = comp_of.get(id(h2))
                    if component is None:
                        component = make_component(h2)
                    component.append(h1)
                    comp_of[id(h1)] = component
                else:
                    component.append(h2)
                    comp_of[id(h2)] = component
            else:
                if h1.sort_key() < h2.sort_key():
                    if component is None:
                        component = make_component(h1)
                    break
                else:
                    if id(h2) not in comp_of:
                        make_component(h2)
                    j += 1
        if component is None and id(h1) not in comp_of:
            make_component(h1)
    while j < len(tp2):
        h2 = tp2[j]
        j += 1
        if id(h2) not in comp_of:
            make_component(h2)
    return components


def merge_two_tiling_paths(tp1: List[RPHmm], tp2: List[RPHmm],
                           include_ancestor: bool = False) -> List[RPHmm]:
    """mergeTwoTilingPaths (coordination.c:263-339)."""
    components = get_overlapping_components(tp1, tp2)
    out = []
    for comp in components:
        sub_paths = get_tiling_paths(comp)
        if len(sub_paths) == 2:
            hmm1 = fuse_tiling_path(sub_paths[0])
            hmm2 = fuse_tiling_path(sub_paths[1])
            RPHmm.align_columns(hmm1, hmm2)
            hmm = RPHmm.cross_product(hmm1, hmm2)
            hmm.forward_backward(include_ancestor=include_ancestor)
            hmm.prune()
        else:
            assert len(sub_paths) == 1 and len(sub_paths[0]) == 1
            hmm = sub_paths[0][0]
        out.append(hmm)
    out.sort(key=lambda h: h.sort_key())
    return out


def merge_tiling_paths(paths: List[List[RPHmm]],
                       include_ancestor: bool = False) -> List[RPHmm]:
    """mergeTilingPaths (coordination.c:341-409): recursive binary merge."""
    if len(paths) == 0:
        return []
    if len(paths) == 1:
        return paths[0]
    if len(paths) > 2:
        half = len(paths) // 2
        tp1 = merge_tiling_paths(paths[:half], include_ancestor)
        tp2 = merge_tiling_paths(paths[half:], include_ancestor)
    else:
        tp1, tp2 = paths[0], paths[1]
    return merge_two_tiling_paths(tp1, tp2, include_ancestor)


def split_where_phasing_is_uncertain(hmm: RPHmm) -> List[RPHmm]:
    """stRPHMM_splitWherePhasingIsUncertain (hmm.c:1322-1383): split the hmm
    between consecutive predicted het sites whose linkage is supported by
    fewer than minReadCoverageToSupportPhasingBetweenHeterozygousSites
    spanning reads. Returns the ordered list of fragments."""
    from margin_tpu.phase.fragment import construct_genome_fragment

    hmm.forward_backward()
    path = hmm.forward_traceback()
    gf = construct_genome_fragment(hmm, path)

    het_sites = [gf.ref_start + i for i in range(gf.length)
                 if gf.haplotype_string1[i] != gf.haplotype_string2[i]]

    out: List[RPHmm] = []
    for j, k in zip(het_sites, het_sites[1:]):
        if not hmm._sites_linkage_is_well_supported(j, k):
            split_point = j + (k - j + 1) // 2
            right = hmm.split(split_point)
            out.append(hmm)
            hmm = right
    out.append(hmm)
    return out


def get_rp_hmms(profile_seqs: List[ProfileSeq], ref: Reference,
                params: PhaseParams) -> List[RPHmm]:
    """getRPHmms (coordination.c:490-516)."""
    hmms = [RPHmm.from_profile_seq(ps, ref, params) for ps in profile_seqs]
    paths = get_tiling_paths(hmms)
    if len(paths) > MAX_READ_PARTITIONING_DEPTH or len(paths) > params.maxCoverageDepth:
        raise RuntimeError(
            f"Coverage depth {len(paths)} exceeds maximum "
            f"{min(MAX_READ_PARTITIONING_DEPTH, params.maxCoverageDepth)}")
    return merge_tiling_paths(paths, include_ancestor=False)


def filter_reads_by_coverage_depth(profile_seqs: List[ProfileSeq], ref: Reference,
                                   params: PhaseParams):
    """filterReadsByCoverageDepth (coordination.c:443-488): drop the
    smallest tiling paths until depth <= maxCoverageDepth. Returns
    (kept, discarded)."""
    hmms = [RPHmm.from_profile_seq(ps, ref, params) for ps in profile_seqs]
    paths = get_tiling_paths(hmms)
    sizes = [sum(h.profile_seqs[0].length for h in p) for p in paths]
    order = sorted(range(len(paths)), key=lambda i: -sizes[i])
    kept, discarded = [], []
    for rank, i in enumerate(order):
        dest = kept if rank < params.maxCoverageDepth else discarded
        for h in paths[i]:
            dest.append(h.profile_seqs[0])
    return kept, discarded
