"""Bubble graph construction from a POA (the polish-path diploid/variant
engine) and consensus path/string extraction.

Parity: impl/bubbleGraph.c:186-423 (candidate machinery, consensus
path/string), :506-602 (read substrings), :910-1123
(bubbleGraph_constructFromPoaAndVCF). Allele supports are scored with the
batched dense pair-HMM kernel, one call per chunk.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from margin_tpu.ops import pairhmm
from margin_tpu.params import Params, PolishParams
from margin_tpu.phase.bubbles import (Bubble, BubbleGraph, ReadSubstring,
                                      _log_sum_exp)
from margin_tpu.polish.poa import Poa, PoaRead
from margin_tpu.rle import RleString


# -- candidate machinery (bubbleGraph.c:188-313) -----------------------------

def get_total_weight(node) -> float:
    return float(node.base_weights.sum())


def get_avg_coverage(poa: Poa, start: int, end: int) -> float:
    return sum(get_total_weight(n) for n in poa.nodes[start:end]) / max(end - start, 1)


def get_candidate_weights(poa: Poa, params: PolishParams) -> np.ndarray:
    """getCandidateWeights (bubbleGraph.c:606-636): windowed average
    coverage x candidateVariantWeight."""
    n = len(poa.nodes)
    window = 100
    out = np.zeros(n)
    if window >= n:
        out[:] = get_avg_coverage(poa, 0, n) * params.candidateVariantWeight
        return out
    weights = np.array([get_total_weight(nd) for nd in poa.nodes])
    total = 0.0
    for i in range(n):
        total += weights[i]
        if i >= window:
            total -= weights[i - window]
            out[i - window // 2] = total / window * params.candidateVariantWeight
    for i in range(window // 2):
        out[i] = out[window // 2]
        out[n - 1 - i] = out[n - 1 - window // 2]
    return out


def _candidate_bases(poa: Poa, node, weight):
    """getNextCandidateBase semantics (bubbleGraph.c:208-220)."""
    from margin_tpu.alphabet import seq_to_symbols
    out = []
    for i in range(5):
        base = "ACGTN"[i]
        if node.base_weights[i] > weight or node.base.upper() == base:
            out.append(base)
    return out


def _candidate_repeat_counts(poa: Poa, node, weight):
    """getNextCandidateRepeatCount (bubbleGraph.c:222-235): 2x weight hack."""
    weight = weight * 2.0
    out = []
    for rc in range(poa.max_repeat_count):
        if node.repeat_count_weights[rc] > weight or node.repeat_count == rc:
            out.append(rc)
    return out


def _candidate_inserts(node, weight):
    return [pi.insert for pi in node.inserts if pi.weight > weight]


def _candidate_deletes(node, weight):
    return [pd.length for pd in node.deletes if pd.weight > weight]


def has_candidate_substitution(poa, node, weight) -> bool:
    return any(b != node.base for b in _candidate_bases(poa, node, weight))


def has_candidate_repeat_change(poa, node, weight) -> bool:
    return any(rc != node.repeat_count for rc in _candidate_repeat_counts(poa, node, weight))


def get_candidate_variant_positions(poa: Poa, weights: np.ndarray) -> np.ndarray:
    """getCandidateVariantOverlapPositions (bubbleGraph.c:638-669)."""
    n = len(poa.nodes)
    out = np.zeros(n, dtype=bool)
    for i, node in enumerate(poa.nodes):
        w = weights[i]
        if (has_candidate_substitution(poa, node, w)
                or has_candidate_repeat_change(poa, node, w)
                or _candidate_inserts(node, w)):
            out[i] = True
        dels = _candidate_deletes(node, w)
        j = max(dels) if dels else 0
        if j > 0:
            out[i] = True
        while j > 0:
            out[i + j] = True
            j -= 1
    return out


def expand_positions(b: np.ndarray, expansion: int) -> np.ndarray:
    """expand (bubbleGraph.c:671-688); note the reference's asymmetric
    window [i-e, i+e)."""
    out = np.zeros_like(b)
    for i in np.flatnonzero(b):
        lo = max(i - expansion, 0)
        hi = min(i + expansion, len(b))  # exclusive, mirrors the C loop
        out[lo:hi] = True
    return out


def get_filtered_anchor_positions(poa: Poa, weights: np.ndarray,
                                  vcf_entries, params: PolishParams):
    """getFilteredAnchorPositions (bubbleGraph.c:733-774). Returns
    (anchors, candidate_variant_positions)."""
    cvp = get_candidate_variant_positions(poa, weights)
    if vcf_entries is not None:
        # updateCandidateVariantPositionsByVcfEntries (bubbleGraph.c:690-731)
        new_cvp = np.zeros_like(cvp)
        it = iter(vcf_entries)
        entry = next(it, None)
        for i in range(len(cvp)):
            is_vcf = entry is not None and entry.ref_pos == i
            new_cvp[i] = is_vcf
            if entry is not None and entry.ref_pos <= i:
                entry = next(it, None)
        cvp = new_cvp
    expanded = expand_positions(cvp, params.columnAnchorTrim)
    return ~expanded, cvp


# -- read substrings over POA intervals (bubbleGraph.c:485-602) --------------

def _skip_dupes(obs, i, read_no):
    while i < len(obs) and obs[i][0] == read_no:
        i += 1
    return i


def get_read_substrings(reads: List[PoaRead], poa: Poa, start: int, end: int,
                        params: PolishParams, should_filter: bool = True):
    """getReadSubstrings2 (bubbleGraph.c:524-598): read intervals aligned to
    POA nodes [start, end). Requires sorted observations."""
    subs: List[ReadSubstring] = []

    def make(read, s, length):
        rs_rle = read.rle_read.substring(s, length)
        if read.qualities is not None and length > 0:
            qv = float(np.asarray(read.qualities[s:s + length], dtype=np.int64).sum()) / length
        else:
            qv = -1.0
        return ReadSubstring(read, rs_rle, qv)

    n_nodes = len(poa.nodes)
    if start == 0:
        if end >= n_nodes:
            for r in reads:
                subs.append(make(r, 0, r.rle_read.length))
        else:
            obs = poa.nodes[end].observations
            i = 0
            while i < len(obs):
                read_no, offset, _ = obs[i]
                subs.append(make(reads[read_no], 0, offset))
                i = _skip_dupes(obs, i + 1, read_no)
    elif end >= n_nodes:
        obs = poa.nodes[start].observations
        i = 0
        while i < len(obs):
            read_no, offset, _ = obs[i]
            r = reads[read_no]
            subs.append(make(r, offset, r.rle_read.length - offset))
            i = _skip_dupes(obs, i + 1, read_no)
    else:
        from_obs = poa.nodes[start].observations
        to_obs = poa.nodes[end].observations
        i = j = 0
        while i < len(from_obs) and j < len(to_obs):
            rf, of, _ = from_obs[i]
            rt, ot, _ = to_obs[j]
            if rf == rt:
                if ot - of > 0:
                    subs.append(make(reads[rf], of, ot - of))
                i = _skip_dupes(from_obs, i + 1, rf)
                j = _skip_dupes(to_obs, j + 1, rt)
            elif rf < rt:
                i = _skip_dupes(from_obs, i + 1, rf)
            else:
                j = _skip_dupes(to_obs, j + 1, rt)

    if should_filter:
        # filterReadSubstrings (bubbleGraph.c:506-522)
        subs.sort(key=lambda rs: -rs.qual_value)
        while len(subs) > params.filterReadsWhileHaveAtLeastThisCoverage:
            rs = subs[-1]
            if rs.qual_value >= params.minAvgBaseQuality or rs.qual_value == -1:
                break
            subs.pop()
    return subs


# -- candidate alleles -------------------------------------------------------

def get_candidate_alleles_from_read_substrings(subs: List[ReadSubstring]):
    """getCandidateAllelesFromReadSubstrings (bubbleGraph.c:847-878):
    group by RLE string + counts; consensus repeat counts per group."""
    groups: Dict[tuple, List[RleString]] = {}
    for rs in subs:
        r = rs.rle_string
        key = (r.bases, tuple(int(c) for c in r.counts))
        groups.setdefault(key, []).append(r)
    alleles = []
    for group in groups.values():
        r = group[-1]
        if r.length == 0:
            alleles.append("")
            continue
        counts = np.zeros(r.length, dtype=np.int64)
        for s in group:
            counts += s.counts
        counts = np.floor(counts / len(group) + 0.5).astype(np.int64)
        counts = np.clip(counts, 1, 255)
        alleles.append(RleString(r.bases, counts).expand())
    return alleles


def get_candidate_consensus_substrings(poa: Poa, start: int, end: int,
                                       weights: np.ndarray, adjustment: float,
                                       max_strings: int) -> Optional[List[str]]:
    """getCandidateConsensusSubstrings (bubbleGraph.c:324-423), iterative
    version of the recursion (built back-to-front)."""
    suffixes = [""]
    for pos in range(end - 1, start - 1, -1):
        node = poa.nodes[pos]
        w = weights[pos] * adjustment
        out = []
        for base in _candidate_bases(poa, node, w):
            for rc in _candidate_repeat_counts(poa, node, w):
                bases = base * rc
                for s in suffixes:
                    out.append(bases + s)
                for insert in _candidate_inserts(node, w):
                    ins = insert.expand()
                    for s in suffixes:
                        out.append(bases + ins + s)
                for dl in _candidate_deletes(node, w):
                    for s in suffixes:
                        cand = bases + (s[dl:] if len(s) - dl >= 0 else "")
                        if cand not in out:
                            out.append(cand)
        if len(out) > max_strings:
            return None
        suffixes = out
    return suffixes


# -- bubble graph from POA (bubbleGraph.c:918-1123) --------------------------

def bubble_graph_from_poa_and_vcf_only_alleles(
        poa: Poa, reads: List[PoaRead], rle_reference: RleString,
        vcf_entries, params: Params, tables: pairhmm.PairHmmTables,
        use_lut: bool = False) -> BubbleGraph:
    """bubbleGraph_constructFromPoaAndVCFOnlyVCFAllele
    (bubbleGraph.c:1126-1290): one bubble per VCF entry with exactly the
    VCF's alleles (plus reference context), no consensus-derived
    candidates. Requires non-RLE params (polish.c:364-367)."""
    from margin_tpu.phase.variants import get_allele_substrings
    pp = params.polish
    expanded_ref = rle_reference.expand()
    poa.sort_observations()
    bubbles: List[Bubble] = []
    pending = []
    for vcf in vcf_entries:
        alleles = get_allele_substrings(vcf, expanded_ref, params, True,
                                        pp.columnAnchorTrim)
        ref_start = vcf.ref_aln_start
        ref_end_incl = vcf.ref_aln_stop_incl
        subs = get_read_substrings(reads, poa, ref_start, ref_end_incl, pp)
        if not subs:  # nothing to phase with (bubbleGraph.c:1152-1156)
            continue
        bubble_reads = list(reversed(subs))  # stList_pop order
        allele_rles = [a.copy() for a in alleles]
        b = Bubble(ref_start, ref_end_incl - ref_start, -1, vcf,
                   allele_rles[0].copy(), bubble_reads, allele_rles,
                   np.zeros((len(allele_rles), len(bubble_reads)),
                            dtype=np.float32))
        b.variant_position_offsets = [vcf.ref_pos]  # bubbleGraph.c:1170-1171
        pending.append(b)
        bubbles.append(b)
    _score_bubbles(pending, tables, pp, use_lut)
    bg = BubbleGraph(bubbles)
    bg.ref_string = poa.ref_string
    return bg


def bubble_graph_from_poa(poa: Poa, reads: List[PoaRead], vcf_entries,
                          params: Params, tables: pairhmm.PairHmmTables,
                          phasing: bool = False,
                          use_lut: bool = False) -> BubbleGraph:
    pp = params.polish
    weights = get_candidate_weights(poa, pp)
    poa.sort_observations()
    anchors, cvp = get_filtered_anchor_positions(poa, weights, vcf_entries, pp)

    bubbles: List[Bubble] = []
    pending = []  # batched scoring

    p_anchor = 0
    n_nodes = len(poa.nodes)
    for i in range(1, n_nodes):
        if not anchors[i]:
            continue
        if i - p_anchor != 1:
            subs = get_read_substrings(reads, poa, p_anchor + 1, i, pp)
            if subs:
                use_read_alleles = (pp.useReadAllelesInPhasing if phasing
                                    else pp.useReadAlleles)
                if use_read_alleles:
                    alleles = get_candidate_alleles_from_read_substrings(subs)
                else:
                    adjustment = 1.0
                    alleles = None
                    while alleles is None:
                        alleles = get_candidate_consensus_substrings(
                            poa, p_anchor + 1, i, weights, adjustment,
                            pp.maxConsensusStrings)
                        adjustment *= 1.5
                ref_sub = poa.ref_string.substring(p_anchor, i - 1 - p_anchor)
                expanded_ref = ref_sub.expand()
                if expanded_ref not in alleles:
                    alleles.append(expanded_ref)
                if len(alleles) > 1:
                    allele_rles = [RleString.encode(a) if pp.useRunLengthEncoding
                                   else RleString.identity(a) for a in alleles]
                    bubble_reads = list(reversed(subs))
                    b = Bubble(p_anchor + 1, i - 1 - p_anchor, -1, None,
                               ref_sub, bubble_reads, allele_rles,
                               np.zeros((len(allele_rles), len(bubble_reads)),
                                        dtype=np.float32))
                    b.variant_position_offsets = [
                        vp for vp in range(i - 1 - p_anchor)
                        if cvp[p_anchor + vp]]
                    pending.append(b)
                    bubbles.append(b)
        p_anchor = i

    _score_bubbles(pending, tables, pp, use_lut)
    bg = BubbleGraph(bubbles)
    bg.ref_string = poa.ref_string
    return bg


def _score_bubbles(bubbles: List[Bubble], tables, pp: PolishParams,
                   use_lut: bool, batch_max: int = 131072):
    # batch_max 128k: one full launch per chunk's bubble scoring instead of
    # several partial ones (each launch has a fixed cost)
    """Batched allele-read support scoring with per-bubble dedup of identical
    read substrings (bubbleGraph.c:1042-1073)."""
    use_rle = pp.useRunLengthEncoding
    pairs, strands, reps, slots = [], [], [], []
    dup_maps = []
    for bi, b in enumerate(bubbles):
        seen: Dict[tuple, int] = {}
        dup = np.arange(len(b.reads))
        allele_syms = [a.symbols() for a in b.alleles]
        allele_reps = ([np.minimum(a.counts, 50) for a in b.alleles]
                       if use_rle else None)
        for k, rs in enumerate(b.reads):
            key = (rs.rle_string.bases, tuple(int(c) for c in rs.rle_string.counts))
            if key in seen:
                dup[k] = seen[key]
                continue
            seen[key] = k
            y = rs.rle_string.symbols()
            yr = np.minimum(rs.rle_string.counts, 50) if use_rle else None
            st = 0 if rs.read.forward_strand else 1
            for j in range(len(b.alleles)):
                pairs.append((allele_syms[j], y))
                strands.append(st)
                if use_rle:
                    reps.append((allele_reps[j], yr))
                slots.append((bi, j, k))
        dup_maps.append(dup)
    if pairs:
        from margin_tpu.parallel import executor
        scores = executor.score_pairs(tables, pairs, strands,
                                      rep_pairs=reps if use_rle else None,
                                      use_lut=use_lut, batch_max=batch_max)
        for (bi, j, k), sc in zip(slots, scores):
            bubbles[bi].allele_read_supports[j, k] = sc
    for b, dup in zip(bubbles, dup_maps):
        for k in range(len(b.reads)):
            if dup[k] != k:
                b.allele_read_supports[:, k] = b.allele_read_supports[:, dup[k]]


# -- consensus path / string (bubbleGraph.c:32-184) --------------------------

def get_consensus_path(bg: BubbleGraph) -> np.ndarray:
    """bubbleGraph_getConsensusPath: per bubble the max-likelihood allele
    (sum of float32 supports over reads, first max wins)."""
    path = np.zeros(len(bg.bubbles), dtype=np.int64)
    for i, b in enumerate(bg.bubbles):
        sums = b.allele_read_supports.astype(np.float64).sum(axis=1)
        best = 0
        for j in range(1, len(sums)):
            if sums[j] > sums[best]:
                best = j
        path[i] = best
    return path


def get_consensus_string(bg: BubbleGraph, path: np.ndarray,
                         pp: PolishParams) -> Tuple[RleString, np.ndarray]:
    """bubbleGraph_getConsensusString (bubbleGraph.c:63-184). Returns
    (consensus, poaToConsensusMap over the old ref string)."""
    ref: RleString = bg.ref_string
    use_rle = pp.useRunLengthEncoding
    n = ref.length
    poa_to_consensus = np.full(n, -1, dtype=np.int64)
    pieces: List[str] = []
    prev_base = "-"
    j = 0
    k = 0
    for i, b in enumerate(bg.bubbles):
        if k < b.ref_start:
            sub = ref.substring(k, b.ref_start - k)
            pieces.append(sub.expand())
            if use_rle and sub.bases[0] == prev_base:
                k += 1
            while k < b.ref_start:
                poa_to_consensus[k] = j
                k += 1
                j += 1
            prev_base = sub.bases[-1]
        allele = b.alleles[int(path[i])]
        pieces.append(allele.expand())
        if allele == b.ref_allele:
            if use_rle and allele.length > 0 and allele.bases[0] == prev_base:
                k += 1
            while k < b.ref_start + b.ref_allele.length:
                poa_to_consensus[k] = j
                k += 1
                j += 1
        else:
            k += b.ref_allele.length
            j += allele.length + (-1 if use_rle and allele.length > 0
                                  and allele.bases[0] == prev_base else 0)
        if allele.length > 0:
            prev_base = allele.bases[-1]
    if k < n:
        sub = ref.substring(k, n - k)
        pieces.append(sub.expand())
        if use_rle and sub.bases[0] == prev_base:
            k += 1
        while k < n:
            poa_to_consensus[k] = j
            k += 1
            j += 1
    expanded = "".join(pieces)
    consensus = RleString.encode(expanded) if use_rle else RleString.identity(expanded)
    assert consensus.length == j, (consensus.length, j)
    return consensus, poa_to_consensus
