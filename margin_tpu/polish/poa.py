"""Partial-order alignment graph: construction, augmentation with
posterior-weighted alignments, consensus calling, and iterative realignment.

Parity: impl/poa.c. The DP alignment of each read runs on the device
(ops/banded.py); the graph bookkeeping (left-shift normalized inserts and
deletes, base/repeat weights, observations) is host-side — pointer-heavy
and tiny next to the alignment compute (SURVEY.md §7.5).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from margin_tpu.alphabet import seq_to_symbols
from margin_tpu.ops import banded, pairhmm
from margin_tpu.ops.logmath import np_log_add_lut
from margin_tpu.params import PolishParams
from margin_tpu.rle import RleString

PAIR1 = 10_000_000  # PAIR_ALIGNMENT_PROB_1 (pairwiseAligner.h:26)
LOG_ZERO = -np.inf


@dataclass
class PoaRead:
    """BamChunkRead for the polish path."""
    read_name: str
    forward_strand: bool
    rle_read: RleString
    qualities: Optional[np.ndarray] = None  # rle-space quals
    full_read_length: int = 0


@dataclass
class PoaInsert:
    insert: RleString
    weight_fwd: float = 0.0
    weight_rev: float = 0.0
    observations: List[Tuple[int, int, float]] = field(default_factory=list)

    @property
    def weight(self):
        return self.weight_fwd + self.weight_rev


@dataclass
class PoaDelete:
    length: int
    weight_fwd: float = 0.0
    weight_rev: float = 0.0
    observations: List[Tuple[int, int, float]] = field(default_factory=list)

    @property
    def weight(self):
        return self.weight_fwd + self.weight_rev


@dataclass
class PoaNode:
    base: str
    repeat_count: int
    base_weights: np.ndarray  # (5,)
    repeat_count_weights: np.ndarray  # (max_repeat,)
    inserts: List[PoaInsert] = field(default_factory=list)
    deletes: List[PoaDelete] = field(default_factory=list)
    observations: List[Tuple[int, int, float]] = field(default_factory=list)  # (readNo, offset, weight)


class Poa:
    """poa_getReferenceGraph (poa.c:112-127): node 0 is an 'N' prefix."""

    # flat per-node observation arrays (node_counts, read_no, offset,
    # weight), stashed by NativePoaBuilder.finish for the vectorized
    # anchor-alignment path; None on Python-built graphs
    _flat_obs = None

    def __init__(self, reference: RleString, max_repeat_count: int):
        self.ref_string = reference.copy()
        self.max_repeat_count = max_repeat_count
        # node weight arrays are VIEWS into shared accumulators so augment
        # can np.add.at the whole read in one call (no per-node loop)
        n = reference.length + 1
        self._bw = np.zeros((n, 5))
        self._rw = np.zeros((n, max_repeat_count))
        self.nodes: List[PoaNode] = [self._make_node("N", 1, 0)]
        for i in range(reference.length):
            self.nodes.append(self._make_node(reference.bases[i].upper(),
                                              int(reference.counts[i]),
                                              i + 1))

    def _make_node(self, base: str, repeat: int, row: int) -> PoaNode:
        if base not in "ACGT":
            base = "N"
        return PoaNode(base, repeat, self._bw[row], self._rw[row])

    # -- augmentation (poa.c:317-543) ---------------------------------------

    def augment(self, read: RleString, read_strand: bool, read_no: int,
                matches: np.ndarray, inserts: np.ndarray, deletes: np.ndarray,
                params: PolishParams):
        """poa_augment: add posterior-weighted matches, left-shifted
        complete-inserts and complete-deletes from one read alignment.

        matches/inserts/deletes: (N,3) arrays of (weight, x, y)."""
        read_syms = read.symbols()
        compare_rc = params.poaConstructCompareRepeatCounts

        # vectorized match accumulation (the per-match loop dominates host
        # time on production-size chunks); matches arrive (x, y)-sorted so
        # per-node observation order matches the reference's sweep
        if len(matches):
            marr = np.asarray(matches)
            ws = marr[:, 0].astype(np.float64)
            xs = marr[:, 1].astype(np.int64)
            ys = marr[:, 2].astype(np.int64)
            syms = read_syms[ys]
            rcs = np.minimum(read.counts[ys].astype(np.int64),
                             self.max_repeat_count - 1)
            np.add.at(self._bw, (xs + 1, syms), ws)
            np.add.at(self._rw, (xs + 1, rcs), ws)
            ys_l = ys.tolist()
            ws_l = ws.tolist()
            starts = np.flatnonzero(np.diff(xs, prepend=xs[0] - 1))
            bounds = np.append(starts, len(xs))
            for s, e in zip(bounds[:-1], bounds[1:]):
                self.nodes[int(xs[s]) + 1].observations.extend(
                    (read_no, ys_l[k], ws_l[k]) for k in range(s, e))

        match_set = {(int(x), int(y)) for _, x, y in matches}

        def is_match(x, y):
            return (x, y) in match_set

        # complete inserts (poa.c:352-449): runs with equal ref coord and
        # consecutive read coords
        ins = sorted(map(tuple, inserts), key=lambda t: (t[1], t[2]))
        i = 0
        n = len(ins)
        while i < n:
            j = i + 1
            while (j < n and ins[j][1] == ins[i][1]
                   and ins[i][2] + j - i == ins[j][2]):
                j += 1
            for k in range(i, j):
                if not is_match(ins[i][1], ins[i][2] + k - i - 1) and \
                        ins[i][2] + k - i - 1 > -1:
                    continue
                for l in range(k, j):
                    if not is_match(ins[i][1] + 1, ins[i][2] + l - i + 1) and \
                            ins[i][2] + l - i + 1 < read.length:
                        continue
                    insert = read.substring(int(ins[k][2]), l + 1 - k)
                    weight = min(ins[m][0] for m in range(k, l + 1))
                    pos = int(ins[i][1]) + 1
                    pos = _get_shift(self.ref_string, pos, insert, compare_rc)
                    suffix = _max_common_suffix(self.ref_string, pos, insert, compare_rc)
                    if suffix > 0:
                        insert.rotate(suffix, params.useRunLengthEncoding)
                        pos -= suffix
                    self._add_insert(pos, insert, weight, read_strand,
                                     (read_no, int(ins[k][2]), float(weight)))
            i = j

        # complete deletes (poa.c:451-539): runs with equal read coord and
        # consecutive ref coords
        dels = sorted(map(tuple, deletes), key=lambda t: (t[2], t[1]))
        i = 0
        n = len(dels)
        while i < n:
            j = i + 1
            while (j < n and dels[j][2] == dels[i][2]
                   and dels[i][1] + j - i == dels[j][1]):
                j += 1
            for k in range(i, j):
                if not is_match(dels[i][1] + k - i - 1, dels[i][2]) and \
                        dels[i][1] + k - i - 1 > -1:
                    continue
                for l in range(k, j):
                    if not is_match(dels[i][1] + l - i + 1, dels[i][2] + 1) and \
                            dels[i][1] + l - i + 1 < self.ref_string.length:
                        continue
                    delete_length = l - k + 1
                    weight = min(dels[m][0] for m in range(k, l + 1))
                    pos = int(dels[i][1]) + k - i
                    dstr = self.ref_string.substring(pos, delete_length)
                    pos = _get_shift(self.ref_string, pos, dstr, compare_rc)
                    pos -= _max_common_suffix(self.ref_string, pos, dstr, compare_rc)
                    self._add_delete(pos, delete_length, weight, read_strand,
                                     (read_no, int(dels[i][2]), float(weight)))
            i = j

    def _add_insert(self, pos, insert, weight, strand, obs):
        node = self.nodes[pos]
        for pi in node.inserts:
            if pi.insert == insert:
                break
        else:
            pi = PoaInsert(insert.copy())
            node.inserts.append(pi)
        if strand:
            pi.weight_fwd += weight
        else:
            pi.weight_rev += weight
        pi.observations.append(obs)

    def _add_delete(self, pos, length, weight, strand, obs):
        node = self.nodes[pos]
        for pd in node.deletes:
            if pd.length == length:
                break
        else:
            pd = PoaDelete(length)
            node.deletes.append(pd)
        if strand:
            pd.weight_fwd += weight
        else:
            pd.weight_rev += weight
        pd.observations.append(obs)

    # -- scoring (poa.c:794-839) --------------------------------------------

    def total_match_weight(self) -> float:
        return sum(n.base_weights[seq_to_symbols(n.base)[0]] for n in self.nodes)

    def total_error_weight(self) -> float:
        """poa_getTotalErrorWeight = disagreement + insert + delete weight."""
        total = 0.0
        for n in self.nodes:
            ref_sym = seq_to_symbols(n.base)[0]
            total += n.base_weights.sum() - n.base_weights[ref_sym]
            total += sum(pi.weight * pi.insert.length for pi in n.inserts)
            total += sum(pd.weight * pd.length for pd in n.deletes)
        return total

    def sort_observations(self):
        """sortBaseObservations (bubbleGraph.c:475-483): by readNo asc then
        weight desc."""
        for n in self.nodes:
            n.observations.sort(key=lambda o: (o[0], -o[2]))

    # -- consensus (poa.c:1350-1588) ----------------------------------------

    def get_consensus(self, params: PolishParams) -> Tuple[RleString, np.ndarray]:
        """poa_getConsensus: 'cheesy profile HMM' forward + greedy traceback.
        Returns (consensus RleString, poaToConsensusMap). Runs on the native
        engine when built (marginpoa.cc mpoa_consensus, bit-identical);
        the Python path below is the oracle."""
        try:
            from margin_tpu.polish import native_poa
            res = native_poa.consensus(self, params)
            if res is not None:
                return res
        except Exception:
            pass
        return self._get_consensus_py(params)

    def _get_consensus_py(self, params: PolishParams):
        """Pure-Python consensus oracle (tests assert the native engine
        matches it exactly)."""
        n_nodes = len(self.nodes)
        total_out = np.zeros(n_nodes)
        fwd = np.full(n_nodes + 1, LOG_ZERO)
        fwd[0] = 0.0
        match_fwd = np.zeros(n_nodes)

        incoming_deletes: List[List[Tuple[int, PoaDelete]]] = [[] for _ in range(n_nodes + 1)]
        for i, node in enumerate(self.nodes):
            for pd in node.deletes:
                incoming_deletes[i + pd.length + 1].append((i, pd))

        for i, node in enumerate(self.nodes):
            total_indel = (sum(pi.weight for pi in node.inserts)
                           + sum(pd.weight for pd in node.deletes))
            if i == 0:
                if n_nodes == 1:
                    match_w = 1.0
                else:
                    match_w = sum(n.base_weights.sum() for n in self.nodes[1:])
                    match_w /= (n_nodes - 1)
                    match_w -= total_indel
            else:
                match_w = node.base_weights.sum() - total_indel
            if match_w <= 0.0:
                match_w = 0.0001
            total_out[i] = match_w + total_indel
            for pi in node.inserts:
                fwd[i + 1] = np_log_add_lut(fwd[i + 1],
                                            fwd[i] + math.log(pi.weight / total_out[i]))
            for pd in node.deletes:
                t = i + pd.length + 1
                fwd[t] = np_log_add_lut(fwd[t],
                                        fwd[i] + math.log(pd.weight / total_out[i]))
            match_fwd[i] = fwd[i] + math.log(match_w / total_out[i])
            fwd[i + 1] = np_log_add_lut(fwd[i + 1], match_fwd[i])

        # greedy traceback (poa.c:1460-1563)
        poa_to_consensus = np.full(n_nodes - 1, -1, dtype=np.int64)
        pieces: List[str] = []
        running_len = 0
        prev_base = "-"
        i = n_nodes
        while i > 0:
            if i < n_nodes:
                node = self.nodes[i]
                base_idx = _get_max_weight(node.base_weights[:5],
                                           seq_to_symbols(node.base)[0],
                                           params.referenceBasePenalty)
                base = "ACGTN"[base_idx]
                if params.useRunLengthEncoding:
                    rc = _get_max_weight(node.repeat_count_weights,
                                         node.repeat_count, params.referenceBasePenalty)
                    rc = 1 if rc == 0 else rc
                    pieces.append(base * rc)
                    if prev_base != base:
                        poa_to_consensus[i - 1] = running_len
                        running_len += 1
                    prev_base = base
                else:
                    pieces.append(base)
                    poa_to_consensus[i - 1] = running_len
                    running_len += 1

            p_node = self.nodes[i - 1]
            max_ins_p = LOG_ZERO
            tot_ins_p = LOG_ZERO
            max_ins = None
            for pi in p_node.inserts:
                p = math.log(pi.weight / total_out[i - 1]) + fwd[i - 1]
                if p > max_ins_p:
                    max_ins_p = p
                    max_ins = pi
                tot_ins_p = np_log_add_lut(tot_ins_p, p)
            max_del_p = LOG_ZERO
            tot_del_p = LOG_ZERO
            max_del = None
            for src, pd in incoming_deletes[i]:
                p = math.log(pd.weight / total_out[src]) + fwd[src]
                if p > max_del_p:
                    max_del_p = p
                    max_del = pd
                tot_del_p = np_log_add_lut(tot_del_p, p)

            if match_fwd[i - 1] >= tot_del_p and match_fwd[i - 1] >= tot_ins_p:
                i -= 1
            elif tot_ins_p >= tot_del_p:
                pieces.append(max_ins.insert.expand())
                if params.useRunLengthEncoding:
                    last = max_ins.insert.bases[-1]
                    running_len += max_ins.insert.length + (0 if last != prev_base else -1)
                    prev_base = max_ins.insert.bases[0]
                else:
                    running_len += max_ins.insert.non_rle_length
                i -= 1
            else:
                i -= max_del.length + 1

        pieces.reverse()
        expanded = "".join(pieces)
        consensus = (RleString.encode(expanded) if params.useRunLengthEncoding
                     else RleString.identity(expanded))
        # reverse map offsets (poa.c:1573-1578)
        sel = poa_to_consensus != -1
        poa_to_consensus[sel] = consensus.length - 1 - poa_to_consensus[sel]
        return consensus, poa_to_consensus

    # -- anchors (poa.c:545-599) --------------------------------------------

    def get_anchor_alignments(self, poa_to_consensus: Optional[np.ndarray],
                              n_reads: int, params: PolishParams) -> List[List]:
        if self._flat_obs is not None:
            return self._anchor_alignments_flat(poa_to_consensus, n_reads,
                                                params)
        anchor_alignments: List[List] = [[] for _ in range(n_reads)]
        ladder = params.minPosteriorProbForAlignmentAnchors
        for i in range(1, len(self.nodes)):
            node = self.nodes[i]
            ci = i - 1 if poa_to_consensus is None else int(poa_to_consensus[i - 1])
            if ci == -1:
                continue
            for read_no, offset, weight in node.observations:
                w = weight / PAIR1
                if w > ladder[0]:
                    expansion = int(ladder[1])
                    for k in range(2, len(ladder), 2):
                        if w >= ladder[k]:
                            expansion = int(ladder[k + 1])
                        else:
                            break
                    pairs = anchor_alignments[read_no]
                    if not pairs:
                        pairs.append((ci, offset, expansion))
                    else:
                        px, py, _ = pairs[-1]
                        if px < ci and py < offset:
                            pairs.append((ci, offset, expansion))
        return anchor_alignments

    def _anchor_alignments_flat(self, poa_to_consensus, n_reads: int,
                                params: PolishParams) -> List[np.ndarray]:
        """Vectorized get_anchor_alignments over the flat observation
        arrays the native POA export stashes: ladder thresholds via a
        prefix-AND select, the per-read strictly-increasing greedy via the
        native dedup — same anchors, same order, as the tuple walk (the
        scalar path above remains the parity oracle)."""
        node_counts, rn, off, wt = self._flat_obs
        ladder = params.minPosteriorProbForAlignmentAnchors
        # consensus index per node (nodes[1:] -> rows 0..n-2)
        n_nodes = len(node_counts)
        node_idx = np.repeat(np.arange(n_nodes, dtype=np.int64), node_counts)
        # node 0 observations never anchor (the walk starts at node 1)
        w = wt / PAIR1
        keep = (node_idx >= 1) & (w > ladder[0])
        if poa_to_consensus is None:
            ci = node_idx - 1
        else:
            p2c = np.asarray(poa_to_consensus, dtype=np.int64)
            ci = np.where(node_idx >= 1, p2c[np.minimum(node_idx, n_nodes - 1)
                                             - 1], -1)
            keep &= ci != -1
        idx = np.flatnonzero(keep)
        if len(idx) == 0:
            return [[] for _ in range(n_reads)]
        w = w[idx]
        ci = ci[idx]
        offs = off[idx]
        reads = rn[idx]
        # ladder: expansion = ladder[2j+1] for the largest prefix j>=1 with
        # w >= ladder[2j] (the scalar walk BREAKS at the first failure)
        exp = np.full(len(idx), int(ladder[1]), dtype=np.int64)
        ok = np.ones(len(idx), dtype=bool)
        for k in range(2, len(ladder), 2):
            ok = ok & (w >= ladder[k])
            exp = np.where(ok, int(ladder[k + 1]), exp)
        # per-read, observation order == node order (flat arrays are
        # node-major): stable sort by read keeps it
        order = np.argsort(reads, kind="stable")
        rows = np.stack([ci[order], offs[order], exp[order]],
                        axis=1).astype(np.int64)
        reads_s = reads[order]
        bounds = np.searchsorted(reads_s, np.arange(n_reads + 1))
        try:
            from margin_tpu.io import native as _native
            L = _native.lib()
        except Exception:
            L = None
        out: List = []
        for r in range(n_reads):
            a, b = bounds[r], bounds[r + 1]
            seg = np.ascontiguousarray(rows[a:b])
            if len(seg) == 0:
                out.append([])
                continue
            if L is not None:
                m = L.mio_rle_dedup(seg, len(seg), 3)
                out.append(seg[:m].copy())
            else:
                keep_rows = []
                px = py = -1
                for x, y, e in seg:
                    if x > px and y > py:
                        keep_rows.append((int(x), int(y), int(e)))
                        px, py = x, y
                out.append(keep_rows)
        return out


def _get_max_weight(weights, ref_idx, penalty) -> int:
    """getMaxWeight (poa.c:1334-1348): the reference index wins if its
    weight discounted by the penalty still beats the best non-reference
    weight (last max wins on ties)."""
    weights = np.asarray(weights, dtype=np.float64)
    max_w = 0.0
    max_idx = -1
    for j in range(len(weights)):
        if j != ref_idx and weights[j] >= max_w:
            max_w = weights[j]
            max_idx = j
    ref_w = weights[ref_idx] if 0 <= ref_idx < len(weights) else 0.0
    return int(ref_idx) if ref_w * penalty >= max_w else int(max_idx)


def _get_shift(ref: RleString, ref_start: int, s: RleString, compare_rc: bool) -> int:
    """getShift (poa.c:269-298): left-shift an indel by multiples of its
    minimal internal repeat."""
    min_rep = 1
    while min_rep < s.length:
        if _has_internal_repeat(s, min_rep, compare_rc):
            break
        min_rep += 1
    k = ref_start - min_rep
    while k >= 0:
        if not _matches_ref_substring(ref, k, s, min_rep, compare_rc):
            break
        ref_start = k
        k -= min_rep
    if (s.length == 1 and compare_rc and ref_start > 0
            and ref.bases[ref_start - 1] == s.bases[0]):
        ref_start -= 1
    return ref_start


def _has_internal_repeat(s: RleString, rep_len: int, compare_rc: bool) -> bool:
    if s.length % rep_len != 0:
        return False
    for i in range(rep_len, s.length, rep_len):
        for j in range(rep_len):
            if s.bases[j] != s.bases[j + i]:
                return False
            if compare_rc and s.counts[j] != s.counts[j + i]:
                return False
    return True


def _matches_ref_substring(ref: RleString, ref_start: int, s: RleString,
                           length: int, compare_rc: bool) -> bool:
    for l in range(length):
        if ref.bases[ref_start + l] != s.bases[l]:
            return False
        if compare_rc and ref.counts[ref_start + l] != s.counts[l]:
            return False
    return True


def _max_common_suffix(ref: RleString, length1: int, s: RleString,
                       compare_rc: bool) -> int:
    """getMaxCommonSuffixLength (poa.c:300-315)."""
    i = 0
    while length1 - i - 1 >= 0 and s.length - i - 1 >= 0:
        if ref.bases[length1 - 1 - i] != s.bases[s.length - 1 - i]:
            break
        if compare_rc and ref.counts[length1 - 1 - i] != s.counts[s.length - 1 - i]:
            break
        i += 1
    return i


def _make_poa_builder(reference: RleString, max_rc: int,
                      params: PolishParams):
    """Native C++ augmentation engine when built (native/marginpoa.cc,
    bit-identical bookkeeping at C speed); the Python Poa otherwise."""
    try:
        from margin_tpu.polish import native_poa
        if native_poa.lib() is not None:
            return native_poa.NativePoaBuilder(reference, max_rc, params)
    except Exception:
        pass
    return Poa(reference, max_rc)


def _finish_poa(poa):
    """Collapse a NativePoaBuilder into the ordinary Poa (no-op for Poa)."""
    return poa.finish() if hasattr(poa, "finish") else poa


# -- realign drivers (poa.c:612-716, 1876-1975) ------------------------------

def _crop_item(reference: RleString, read: PoaRead, anchors,
               params: PolishParams):
    """The reference-cropping half of
    getAlignedPairsWithIndelsCroppingReference (poa.c:612-666). Returns
    (kernel item dict, first_ref)."""
    anchors = (np.zeros((0, 3), dtype=np.int64) if anchors is None
               else np.asarray(anchors, dtype=np.int64).reshape(-1, 3))
    if len(anchors):
        fx, fy = int(anchors[0, 0]), int(anchors[0, 1])
        first_ref = max(fx - fy, 0)
        lx_, ly_ = int(anchors[-1, 0]), int(anchors[-1, 1])
        end_ref = min(1 + lx_ + (read.rle_read.length - ly_), reference.length)
    else:
        first_ref, end_ref = 0, reference.length
    adj_anchors = anchors.copy()
    adj_anchors[:, 0] -= first_ref
    item = {
        "x_sym": reference.symbols()[first_ref:end_ref],
        "y_sym": read.rle_read.symbols(),
        "anchors": adj_anchors,
        "strand": 0 if read.forward_strand else 1,
    }
    if params.useRepeatCountsInAlignment:
        item["rep_x"] = reference.counts[first_ref:end_ref]
        item["rep_y"] = read.rle_read.counts
    return item, first_ref


def get_aligned_pairs_cropping_reference(reference: RleString, read: PoaRead,
                                         anchors: List[Tuple[int, int, int]],
                                         params: PolishParams,
                                         tables: pairhmm.PairHmmTables,
                                         use_lut: bool = False):
    """getAlignedPairsWithIndelsCroppingReference (poa.c:612-666).
    Returns (matches, inserts, deletes) weighted-pair arrays in reference
    coordinates."""
    item, first_ref = _crop_item(reference, read, anchors, params)
    (m, gx, gy), _total = banded.banded_posteriors_split(
        tables, item["x_sym"], item["y_sym"], item["anchors"],
        params.p.diagonalExpansion, item["strand"],
        params.p.splitMatrixBiggerThanThis,
        threshold=params.p.threshold, use_lut=use_lut,
        dynamic=params.p.dynamicAnchorExpansion,
        rep_x=item.get("rep_x"), rep_y=item.get("rep_y"))
    # matches/gapX(deletes)/gapY(inserts); shift ref coords back
    for arr in (m, gx, gy):
        if len(arr):
            arr[:, 1] += first_ref
    return m, gy, gx  # (matches, inserts, deletes)


def poa_realign_only_anchor_alignments(reads: List[PoaRead], anchor_alignments,
                                       reference: RleString,
                                       params: PolishParams) -> Poa:
    """poa_realignOnlyAnchorAlignments (poa.c:718-788): convert each read's
    anchor alignment (CIGAR-derived) directly into weight-1.0 matches and
    indels without any DP."""
    max_rc = 2
    if params.useRunLengthEncoding:
        max_rc = (params.repeat_sub_matrix.max_repeat
                  if params.repeat_sub_matrix is not None else 51)
    poa = _make_poa_builder(reference, max_rc, params)
    for i, read in enumerate(reads):
        aln = anchor_alignments[i]
        aln = [] if aln is None else [tuple(int(v) for v in a) for a in aln]
        matches, inserts, deletes = [], [], []
        if aln:
            it = iter(aln)
            cur = next(it, None)
            pos_ref, pos_read = cur[0], cur[1]
            while cur is not None:
                ca_ref, ca_read = cur[0], cur[1]
                if pos_ref < ca_ref:
                    deletes.append((PAIR1, pos_ref, ca_read - 1))
                    pos_ref += 1
                elif pos_read < ca_read:
                    inserts.append((PAIR1, ca_ref - 1, pos_read))
                    pos_read += 1
                else:
                    matches.append((PAIR1, pos_ref, pos_read))
                    pos_ref += 1
                    pos_read += 1
                    cur = next(it, None)
        poa.augment(read.rle_read, read.forward_strand, i,
                    np.array(matches, dtype=np.int64).reshape(-1, 3),
                    np.array(inserts, dtype=np.int64).reshape(-1, 3),
                    np.array(deletes, dtype=np.int64).reshape(-1, 3), params)
    return _finish_poa(poa)


def poa_realign(reads: List[PoaRead], anchor_alignments, reference: RleString,
                params: PolishParams, tables: pairhmm.PairHmmTables,
                use_lut: bool = False, batched: bool = True) -> Poa:
    """poa_realign (poa.c:668-716).

    The per-read banded alignments are grouped by padded shape and run as
    vmapped kernel batches — one launch per (shape, strand) group instead
    of one per read, which amortizes scan-step overhead (the bands are
    narrow, so the sequential scan is latency-bound) and launch round
    trips on accelerators. Augmentation stays strictly in read order so
    float accumulation matches the reference's sequential loop."""
    max_rc = 2
    if params.useRunLengthEncoding:
        max_rc = (params.repeat_sub_matrix.max_repeat
                  if params.repeat_sub_matrix is not None else 51)
    poa = _make_poa_builder(reference, max_rc, params)
    if batched:
        items = []
        firsts = []
        split_map = {}  # read idx -> [(item idx, (x1, y1)), ...]
        for i, read in enumerate(reads):
            anchors = (anchor_alignments[i]
                       if anchor_alignments is not None else [])
            item, first_ref = _crop_item(reference, read, anchors, params)
            splits = banded.get_split_points(
                item["anchors"], len(item["x_sym"]), len(item["y_sym"]),
                params.p.splitMatrixBiggerThanThis, False, False)
            if len(splits) > 1:
                # large-gap reads: ragged sub-rectangles join the same
                # batched solve (pairwiseAligner.c:984-1040 semantics)
                subs, offs = banded.split_sub_items(
                    item, params.p.splitMatrixBiggerThanThis)
                split_map[i] = [(len(items) + 1 + k, offs[k])
                                for k in range(len(subs))]
                item = {"x_sym": item["x_sym"][:0], "y_sym": item["y_sym"][:0],
                        "anchors": [], "strand": item["strand"]}
                items.append(item)
                items.extend(subs)
            else:
                items.append(item)
            firsts.append(first_ref)
        results = banded.banded_posteriors_many(
            tables, items, params.p.diagonalExpansion,
            threshold=params.p.threshold, use_lut=use_lut,
            dynamic=params.p.dynamicAnchorExpansion)
        read_item_idx = {}
        j = 0
        for i in range(len(reads)):
            read_item_idx[i] = j
            j += 1 + len(split_map.get(i, ()))
        for i, read in enumerate(reads):
            if i in split_map:
                parts = [[], [], []]
                for sub_idx, (x1, y1) in split_map[i]:
                    (sm, sgx, sgy), _t = results[sub_idx]
                    for acc, arr in zip(parts, (sm, sgx, sgy)):
                        if len(arr):
                            arr = arr.copy()
                            arr[:, 1] += x1
                            arr[:, 2] += y1
                            acc.append(arr)
                empty = np.zeros((0, 3), dtype=np.int64)
                m, gx, gy = (np.concatenate(p) if p else empty
                             for p in parts)
            else:
                (m, gx, gy), _total = results[read_item_idx[i]]
            for arr in (m, gx, gy):
                if len(arr):
                    arr[:, 1] += firsts[i]
            poa.augment(read.rle_read, read.forward_strand, i, m, gy, gx,
                        params)
        return _finish_poa(poa)
    for i, read in enumerate(reads):
        anchors = anchor_alignments[i] if anchor_alignments is not None else []
        matches, inserts, deletes = get_aligned_pairs_cropping_reference(
            reference, read, anchors, params, tables, use_lut)
        poa.augment(read.rle_read, read.forward_strand, i,
                    matches, inserts, deletes, params)
    return _finish_poa(poa)
