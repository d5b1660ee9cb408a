"""Genomic chunk geometry from a BAM scan.

Parity: bamChunker_construct2 (htsIntegration.c:203-396) — one sequential
pass over the (region-filtered) BAM finds per-contig aligned extents and
bucketed depth estimates, then emits fixed-size chunks with overlap margins
(saveContigChunks, htsIntegration.c:151-179).

Device mapping: a chunk is the unit of data parallelism; the estimated depth
drives static bucketing for padded device batches.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

import numpy as np

from margin_tpu.io import bam as bamio
from margin_tpu.io.vcf import parse_region
from margin_tpu.params import PolishParams


@dataclass
class BamChunk:
    ref_name: str
    chunk_idx: int
    chunk_overlap_start: int
    chunk_start: int
    chunk_end: int
    chunk_overlap_end: int
    estimated_depth: int


@dataclass
class BamChunker:
    bam_file: str
    chunk_size: int
    chunk_boundary: int
    chunks: List[BamChunk] = field(default_factory=list)
    read_enumerator: Dict[str, int] = field(default_factory=dict)


def get_read_name(rec: bamio.BamRecord, ref_name: str) -> str:
    """Unique read naming; supplementary alignments get a synthesized
    suffix hashed over the cigar (getReadName, htsIntegration.c:523-542)."""
    if not rec.is_supplementary:
        return rec.name
    h = 37
    mask = (1 << 64) - 1
    for v in rec.cigar:
        op = int(v) & 0xF
        ln = int(v) >> 4
        h = (97 * h + op) & mask
        h = (193 * h + ln) & mask
    strand = "r" if rec.is_reverse else "f"
    return f"{rec.name}@@{ref_name}:{rec.pos}{strand}#{h}"


def aligned_read_length(rec: bamio.BamRecord, boundary_at_match: bool = False):
    """getAlignedReadLength3 (htsIntegration.c:37-107). Returns
    (aligned_length, start_softclip, end_softclip)."""
    ops = rec.cigar_ops()
    n = len(ops)
    start_sc = end_sc = 0
    i = 0
    while i < n:
        op, num = ops[i]
        if op in (bamio.CMATCH, bamio.CEQUAL, bamio.CDIFF):
            break
        elif op in (bamio.CDEL, bamio.CREF_SKIP):
            if not boundary_at_match:
                break
            i += 1
        elif op == bamio.CINS:
            if not boundary_at_match:
                break
            start_sc += num
            i += 1
        elif op == bamio.CSOFT_CLIP:
            start_sc += num
            i += 1
        else:  # hard clip / pad
            i += 1
    i = n - 1
    while i > 0:
        op, num = ops[i]
        if op in (bamio.CMATCH, bamio.CEQUAL, bamio.CDIFF):
            break
        elif op in (bamio.CDEL, bamio.CREF_SKIP):
            if not boundary_at_match:
                break
            i -= 1
        elif op == bamio.CINS:
            if not boundary_at_match:
                break
            end_sc += num
            i -= 1
        elif op == bamio.CSOFT_CLIP:
            end_sc += num
            i -= 1
        else:
            i -= 1
    num_ins = int(ops[ops[:, 0] == bamio.CINS, 1].sum())
    num_del = int(ops[ops[:, 0] == bamio.CDEL, 1].sum())
    true_len = rec.l_seq - start_sc - end_sc + num_del - num_ins
    return true_len, start_sc, end_sc


def _bucket_size(chunk_size: int) -> int:
    return max(chunk_size // 32, 1)  # htsIntegration.c:127-131


def _estimated_depth(depth_buckets: List[int], start: int, end_excl: int,
                     chunk_size: int) -> int:
    bs = _bucket_size(chunk_size)
    start //= bs
    end_excl //= bs
    end_excl = min(end_excl, len(depth_buckets))
    total = sum(depth_buckets[start:end_excl])
    span = max(end_excl - start, 1)
    return total // span


def construct_chunker(bam_file: str, region: Optional[str],
                      valid_contigs: Optional[Set[str]],
                      params: PolishParams,
                      record_filtered_reads: bool = True) -> BamChunker:
    """bamChunker_construct2 (htsIntegration.c:203-396). Uses the native
    scan engine when available (one C pass + vectorized geometry)."""
    try:
        from margin_tpu.io import native
        if native.lib() is not None and not bamio.is_cram(bam_file):
            return _construct_chunker_native(bam_file, region, valid_contigs,
                                             params, record_filtered_reads)
    except Exception:
        pass
    return _construct_chunker_py(bam_file, region, valid_contigs, params,
                                 record_filtered_reads)


def _scan_cached(bam_file: str):
    """The native whole-BAM scan is param-independent — cache it on disk
    keyed by file identity so worker processes and the shard-merge pass
    don't re-inflate the BAM (htsIntegration.c re-streams per process too,
    but its htslib pass rides the OS page cache; here the inflate itself
    is the cost). ~0.5 s per scan of a 40 MB BAM."""
    import hashlib
    import os
    import pickle
    import tempfile

    from margin_tpu.io import native

    st = os.stat(bam_file)
    key = hashlib.sha256(
        f"{os.path.abspath(bam_file)}|{st.st_size}|{st.st_mtime_ns}|v1"
        .encode()).hexdigest()[:24]
    cache = os.path.join(tempfile.gettempdir(), "margin_tpu_scan_cache")
    path = os.path.join(cache, key + ".pkl")
    try:
        with open(path, "rb") as fh:
            return pickle.load(fh)
    except Exception:
        pass
    with native.NativeBam(bam_file) as nb:
        scan = nb.scan()
        ref_names = nb.ref_names
    try:
        os.makedirs(cache, exist_ok=True)
        tmp = path + f".tmp{os.getpid()}"
        with open(tmp, "wb") as fh:
            pickle.dump((scan, ref_names), fh,
                        protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)  # atomic: concurrent workers race safely
    except Exception:
        pass
    return scan, ref_names


def _construct_chunker_native(bam_file, region, valid_contigs, params,
                              record_filtered_reads) -> BamChunker:
    region_contig, region_start, region_end = parse_region(region)
    chunk_size, margin = params.chunkSize, params.chunkBoundary
    chunker = BamChunker(bam_file, chunk_size, margin)

    scan, ref_names = _scan_cached(bam_file)

    tid = scan["tid"]
    pos = scan["pos"]
    flag = scan["flag"]
    keep = (scan["aligned_len"] > 0) & ((flag & bamio.FUNMAP) == 0)
    if not params.includeSecondaryAlignments:
        keep &= (flag & bamio.FSECONDARY) == 0
    if not params.includeSupplementaryAlignments:
        keep &= (flag & bamio.FSUPPLEMENTARY) == 0
    if not record_filtered_reads:
        keep &= scan["mapq"] >= params.filterAlignmentsWithMapQBelowThisThreshold
    end = pos + scan["aligned_len"]
    if region_contig is not None:
        rid = ref_names.index(region_contig) if region_contig in ref_names else -1
        keep &= tid == rid
        if region_start >= 0:
            keep &= (pos < region_end) & (end > max(region_start - 1, 0))
    if valid_contigs is not None:
        valid_ids = np.array([i for i, n in enumerate(ref_names)
                              if n in valid_contigs])
        keep &= np.isin(tid, valid_ids)

    idx = np.flatnonzero(keep)
    # read enumerator in scan order
    read_idx = 1
    names = scan["names"]
    for i in idx:
        name = names[i]
        if name not in chunker.read_enumerator:
            chunker.read_enumerator[name] = read_idx
            read_idx += 1

    bs = _bucket_size(chunk_size)
    # contigs in encounter order
    seen = []
    for t in tid[idx]:
        if not seen or seen[-1] != t:
            if t not in seen:
                seen.append(int(t))
    for t in seen:
        sel = idx[tid[idx] == t]
        c_start = int(pos[sel].min())
        c_end = int(end[sel].max())
        if (region_contig is not None and region_start > 0 and region_end > 0):
            c_start = max(c_start, region_start)
            c_end = min(c_end, region_end)
        # depth buckets (storeReadDepthInformation)
        n_buckets = int(end[sel].max() // bs) + 1
        buckets = np.zeros(n_buckets + 1, dtype=np.int64)
        b0 = pos[sel] // bs
        b1 = end[sel] // bs
        np.add.at(buckets, b0, 1)
        np.add.at(buckets, np.minimum(b1, n_buckets), -1)
        buckets = np.cumsum(buckets)[:n_buckets]
        blist = buckets.tolist()
        contig = ref_names[t]
        if chunk_size == 0:
            chunker.chunks.append(BamChunk(contig, len(chunker.chunks), c_start,
                                           c_start, c_end, c_end,
                                           _estimated_depth(blist, c_start, c_end, chunk_size)))
        else:
            i = c_start
            while i < c_end:
                ce = min(i + chunk_size, c_end)
                ms = max(i - margin, c_start)
                me = min(ce + margin, c_end)
                chunker.chunks.append(BamChunk(contig, len(chunker.chunks), ms,
                                               i, ce, me,
                                               _estimated_depth(blist, ms, me, chunk_size)))
                i += chunk_size
    return chunker


def _construct_chunker_py(bam_file: str, region: Optional[str],
                          valid_contigs: Optional[Set[str]],
                          params: PolishParams,
                          record_filtered_reads: bool = True) -> BamChunker:
    """Pure-Python chunker (fallback)."""
    region_contig, region_start, region_end = parse_region(region)
    chunk_size, margin = params.chunkSize, params.chunkBoundary
    chunker = BamChunker(bam_file, chunk_size, margin)
    read_idx = 1

    current_contig = None
    contig_start = contig_end = 0
    depth_buckets: List[int] = []

    def save_contig(contig, cstart, cend, buckets):
        if chunk_size == 0:
            chunker.chunks.append(BamChunk(contig, len(chunker.chunks), cstart,
                                           cstart, cend, cend,
                                           _estimated_depth(buckets, cstart, cend, chunk_size)))
            return
        i = cstart
        while i < cend:
            ce = min(i + chunk_size, cend)
            ms = max(i - margin, cstart)
            me = min(ce + margin, cend)
            chunker.chunks.append(BamChunk(contig, len(chunker.chunks), ms, i,
                                           ce, me,
                                           _estimated_depth(buckets, ms, me, chunk_size)))
            i += chunk_size

    with bamio.open_alignment(bam_file) as reader:
        if region_contig is not None:
            # bed_hash_regions treats 'chr:start-end' as 1-based inclusive, so
            # the reference effectively scans 0-based [start-1, end)
            it = reader.fetch(region_contig, max(region_start - 1, 0),
                              region_end if region_end > 0 else (1 << 60))
        else:
            it = iter(reader)
        for rec in it:
            if rec.l_seq <= 0 or len(rec.cigar) == 0 or rec.is_unmapped:
                continue
            if not params.includeSecondaryAlignments and rec.is_secondary:
                continue
            if not params.includeSupplementaryAlignments and rec.is_supplementary:
                continue
            if rec.mapq < params.filterAlignmentsWithMapQBelowThisThreshold:
                if not record_filtered_reads:
                    continue
            contig = reader.header.ref_names[rec.ref_id]
            if valid_contigs is not None and contig not in valid_contigs:
                continue
            aln_len, _, _ = aligned_read_length(rec)
            if aln_len <= 0:
                continue
            start = rec.pos
            end = start + aln_len
            if current_contig is None:
                current_contig = contig
                contig_start, contig_end = start, end
            elif contig == current_contig:
                contig_start = min(contig_start, start)
                contig_end = max(contig_end, end)
            else:
                save_contig(current_contig, contig_start, contig_end, depth_buckets)
                current_contig = contig
                contig_start, contig_end = start, end
                depth_buckets = []
            # depth buckets (storeReadDepthInformation, htsIntegration.c:181-191)
            bs = _bucket_size(chunk_size)
            b0, b1 = start // bs, end // bs
            if len(depth_buckets) <= b1:
                depth_buckets.extend([0] * (b1 + 1 - len(depth_buckets)))
            for b in range(b0, b1):
                depth_buckets[b] += 1
            # read enumerator
            name = get_read_name(rec, contig)
            if name not in chunker.read_enumerator:
                chunker.read_enumerator[name] = read_idx
                read_idx += 1
        if current_contig is not None:
            if region_contig is not None and region_start > 0 and region_end > 0:
                contig_start = max(contig_start, region_start)
                contig_end = min(contig_end, region_end)
            save_contig(current_contig, contig_start, contig_end, depth_buckets)
    return chunker
