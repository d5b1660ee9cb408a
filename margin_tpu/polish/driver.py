"""`margin polish` driver (haploid + diploid).

Parity: polish_main (polish.c:87-1014). Haploid: per chunk realign reads to
the reference with the banded device kernel, build the POA, call consensus
iteratively, re-estimate run lengths, then stitch chunk sequences into the
polished FASTA. Diploid adds bubble-graph phasing over the POA, per-hap
consensus and phased outputs.
"""

from __future__ import annotations

import os
import random
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from margin_tpu.io import bam as bamio
from margin_tpu.io.fasta import FastaIndex, write_fasta
from margin_tpu.ops import pairhmm
from margin_tpu.params import Params
from margin_tpu.phase import chunker as chunkermod
from margin_tpu.polish import bubbles_poa, repeats, stitcher
from margin_tpu.polish.poa import Poa, PoaRead, poa_realign
from margin_tpu.polish.reads import convert_to_reads_and_alignments
from margin_tpu.rle import RleString
from margin_tpu.utils import profiling


@dataclass
class PolishOutputs:
    fasta: Optional[str] = None
    sequences: Optional[list] = None
    hap1_fasta: Optional[str] = None
    hap2_fasta: Optional[str] = None
    haplotagged_bam: Optional[str] = None
    hap1_count: int = 0
    hap2_count: int = 0


def poa_realign_iterative(poa: Poa, reads: List[PoaRead], params: Params,
                          tables, hmm_not_realign: bool,
                          min_iterations: int, max_iterations: int,
                          use_lut: bool = False, profiler=profiling.NULL,
                          chunk_idx: int = 0) -> Poa:
    """poa_realignIterative (poa.c:1876-1952)."""
    pp = params.polish
    score = poa.total_match_weight() - poa.total_error_weight()
    i = 0
    while i < max_iterations:
        i += 1
        # separate labels: r4's single "consensus" stage hid the
        # bubble-polish iteration's graph build + allele scoring (the
        # dominant cost) behind the profile-HMM consensus's name
        if hmm_not_realign:
            with profiler.chunk_stage(chunk_idx, "consensus"):
                reference, poa_to_consensus = poa.get_consensus(pp)
        else:
            with profiler.chunk_stage(chunk_idx, "polish_bubbles"):
                bg = bubbles_poa.bubble_graph_from_poa(
                    poa, reads, None, params, tables, use_lut=use_lut)
                path = bubbles_poa.get_consensus_path(bg)
                reference, poa_to_consensus = \
                    bubbles_poa.get_consensus_string(bg, path, pp)
        if reference == poa.ref_string:
            break
        with profiler.chunk_stage(chunk_idx, "anchors"):
            anchor_alignments = poa.get_anchor_alignments(poa_to_consensus,
                                                          len(reads), pp)
        with profiler.chunk_stage(chunk_idx, "realign"):
            poa2 = poa_realign(reads, anchor_alignments, reference, pp,
                               tables, use_lut=use_lut)
        if pp.useRunLengthEncoding:
            with profiler.chunk_stage(chunk_idx, "repeat_counts"):
                repeats.estimate_repeat_counts(poa2, reads,
                                               pp.repeat_sub_matrix)
        score2 = poa2.total_match_weight() - poa2.total_error_weight()
        if score2 <= score and i > min_iterations:
            break
        poa = poa2
        score = score2
    return poa


def poa_realign_all(reads: List[PoaRead], alignments, reference: RleString,
                    params: Params, tables, use_lut: bool = False,
                    profiler=profiling.NULL, chunk_idx: int = 0) -> Poa:
    """poa_realignAll (poa.c:1955-1975)."""
    pp = params.polish
    with profiler.chunk_stage(chunk_idx, "realign"):
        poa = poa_realign(reads, alignments, reference, pp, tables,
                          use_lut=use_lut)
    if pp.maxPoaConsensusIterations > 0:
        poa = poa_realign_iterative(poa, reads, params, tables, True,
                                    pp.minPoaConsensusIterations,
                                    pp.maxPoaConsensusIterations, use_lut,
                                    profiler, chunk_idx)
    if pp.maxRealignmentPolishIterations > 0:
        poa = poa_realign_iterative(poa, reads, params, tables, False,
                                    pp.minRealignmentPolishIterations,
                                    pp.maxRealignmentPolishIterations,
                                    use_lut, profiler, chunk_idx)
    return poa


def _write_chunks_csv(output_base: str, chunkr) -> None:
    """The per-run chunk geometry dump (polish.c:410-418)."""
    with open(f"{output_base}.chunks.csv", "w") as fh:
        for c in chunkr.chunks:
            fh.write(f"{c.ref_name},{c.chunk_overlap_start},"
                     f"{c.chunk_overlap_end},{c.chunk_start},{c.chunk_end}\n")


def run_polish(bam_file: str, reference_fasta: str, params: Params,
               output_base: str, region: Optional[str] = None,
               diploid: bool = False, seed: int = 0, use_lut: bool = False,
               feature_type: Optional[str] = None, feature_max_rl: int = 0,
               true_reference_bam: Optional[str] = None,
               full_feature_output: bool = False,
               output_poa_csv: bool = False, output_poa_dot: bool = False,
               output_repeat_counts: bool = False,
               output_haplotype_reads: bool = False,
               output_phasing_state: bool = False,
               vcf_file: Optional[str] = None,
               only_use_vcf_alleles: bool = False,
               skip_output_fasta: bool = False,
               checkpoint: bool = False,
               shard: Optional[tuple] = None,
               skip_filtered_reads: bool = False,
               skip_realignment: bool = False,
               skip_haplotype_bam: bool = False,
               profiler=None,
               threads: int = 1,
               hosts: Optional[tuple] = None,
               log=print) -> PolishOutputs:
    """polish_main (polish.c:87-1014). In diploid mode a true_reference_bam
    enables truth-sequence partitioning (polish.c:423-431). shard=(i, n)
    polishes every nth chunk (offset i) into the shared checkpoint dir;
    shard=("merge",) combines (see run_phase). threads>1 runs chunks on a
    host thread pool (polish.c:475-478) with per-chunk RNG streams — the
    same streams as shard mode, so threaded == sharded byte-for-byte.
    hosts=(coordinator, N, host_id) scales chunks across a jax.distributed
    process group like run_phase: one all-gather of chunk consensus
    records, host 0 stitches and writes (SURVEY §7.8)."""
    bamio.set_cram_reference(reference_fasta)
    if diploid:
        return run_polish_diploid(bam_file, reference_fasta, params,
                                  output_base, region=region, seed=seed,
                                  use_lut=use_lut,
                                  output_poa_csv=output_poa_csv,
                                  output_poa_dot=output_poa_dot,
                                  output_repeat_counts=output_repeat_counts,
                                  output_haplotype_reads=output_haplotype_reads,
                                  output_phasing_state=output_phasing_state,
                                  vcf_file=vcf_file,
                                  only_use_vcf_alleles=only_use_vcf_alleles,
                                  skip_output_fasta=skip_output_fasta,
                                  checkpoint=checkpoint,
                                  true_reference_bam=true_reference_bam,
                                  shard=shard,
                                  skip_filtered_reads=skip_filtered_reads,
                                  skip_realignment=skip_realignment,
                                  skip_haplotype_bam=skip_haplotype_bam,
                                  threads=threads,
                                  hosts=hosts,
                                  log=log)
    from margin_tpu.utils import profiling
    profiler = profiler or profiling.NULL
    rng = random.Random(seed)
    mh = None
    if hosts is not None:
        if feature_type is not None:
            raise ValueError("HELEN feature output is per-host; run --hosts "
                             "without -f or shard features separately")
        from margin_tpu.parallel import multihost as mh
        coordinator, n_hosts, host_id = hosts
        mh.init(coordinator, int(n_hosts), int(host_id))
        log(f"> Multi-host: host {host_id}/{n_hosts} via {coordinator}")
    shard_idx = shard_n = None
    if shard is not None:
        checkpoint = True
        if shard[0] != "merge":
            shard_idx, shard_n = int(shard[0]), int(shard[1])
    t0 = time.time()
    pp = params.polish

    helen_h5 = None
    if feature_type is not None:
        from margin_tpu.polish import helen
        feature_type = helen.normalize_feature_type(feature_type)
        # polish.c:374-383: simpleWeight requires non-RLE params, the RLE
        # feature types require RLE params
        if feature_type == "simpleWeight" and pp.useRunLengthEncoding:
            raise ValueError("Invalid runLengthEncoding parameter because "
                             "of HELEN feature type.")
        if feature_type != "simpleWeight" and not pp.useRunLengthEncoding:
            raise ValueError("Invalid runLengthEncoding parameter because "
                             "of HELEN feature type.")
        if feature_max_rl <= 0:
            feature_max_rl = helen.SPLIT_MAX_RUN_LENGTH_DEFAULT
        # openHelenFeatureHDF5FilesByThreadCount (helenFeatures.c:2782-2790)
        helen_h5 = helen.HelenHDF5File(f"{output_base}.T00.h5")

    chunkr = chunkermod.construct_chunker(bam_file, region, None, pp,
                                          record_filtered_reads=False)
    log(f"> Built {len(chunkr.chunks)} chunks")
    _write_chunks_csv(output_base, chunkr)
    fasta = FastaIndex(reference_fasta)
    tables = pairhmm.PairHmmTables.from_params(
        pp.sm_forward, pp.sm_reverse,
        repeat=pp.repeat_sub_matrix if pp.useRepeatCountsInAlignment else None)

    # multi-chip: shard scoring batches over a ("dp","sp") mesh (SURVEY §2.3)
    from margin_tpu.parallel import executor
    if executor.context().mesh is None and not executor.context().pinned:
        try:
            import jax
            if jax.default_backend() != "cpu" and jax.device_count() > 1:
                executor.enable_mesh(log=log)
        except Exception:
            pass

    from margin_tpu.utils.checkpoint import ChunkCheckpointer
    if checkpoint and helen_h5 is not None:
        # the HDF5 feature file is rewritten whole each run, so skipped
        # chunks would lose their features
        log("> Checkpointing disabled: incompatible with HELEN feature output")
        checkpoint = False
    ckpt = ChunkCheckpointer(
        f"{output_base}.checkpoint", enabled=checkpoint,
        meta={"bam": os.path.abspath(bam_file), "region": region,
              "seed": seed, "diploid": False,
              "n_chunks": len(chunkr.chunks),
              "per_chunk_rng": (shard is not None or threads > 1
                                or hosts is not None)},
        log=log)

    threads = max(int(threads), 1)
    per_chunk_rng = shard is not None or threads > 1 or hosts is not None
    my_chunks = [c for c in chunkr.chunks
                 if shard_idx is None or c.chunk_idx % shard_n == shard_idx]
    if mh is not None:
        my_chunks = [c for c in my_chunks
                     if c.chunk_idx % mh.num_hosts() == mh.host_id()]
    import threading as _threading
    io_lock = _threading.Lock()  # serializes HELEN h5 + sequential-rng ckpt

    def process_chunk(chunk, reader, chunk_rng):
        payload = ckpt.load(chunk.chunk_idx)
        if payload is not None:
            if payload.get("rng_state") is not None:
                chunk_rng.setstate(payload["rng_state"])
            return payload["seq"]
        raw_ref = fasta.fetch(chunk.ref_name, chunk.chunk_overlap_start,
                              chunk.chunk_overlap_end).upper()
        rle_ref = (RleString.encode(raw_ref) if pp.useRunLengthEncoding
                   else RleString.identity(raw_ref))
        with profiler.chunk_stage(chunk.chunk_idx, "readextract"):
            reads, alignments, _fr, _fa = convert_to_reads_and_alignments(
                chunk, rle_ref, reader, pp, keep_filtered=False)
        # downsample (polish.c:536-576, haploid uses downsampleViaReadLikelihood)
        if pp.maxDepth > 0 and reads:
            total_nt = sum(r.rle_read.length for r in reads)
            span = chunk.chunk_overlap_end - chunk.chunk_overlap_start
            avg = total_nt / span
            if avg >= pp.maxDepth:
                ratio = pp.maxDepth / avg
                kept_r, kept_a = [], []
                for r, a in zip(reads, alignments):
                    if chunk_rng.random() < ratio:
                        kept_r.append(r)
                        kept_a.append(a)
                reads, alignments = kept_r, kept_a
        with profiler.chunk_stage(chunk.chunk_idx, "poa_realign"):
            poa = poa_realign_all(reads, alignments, rle_ref, params, tables,
                                  use_lut, profiler, chunk.chunk_idx)
        if pp.useRunLengthEncoding:
            with profiler.chunk_stage(chunk.chunk_idx, "repeat_counts"):
                repeats.estimate_repeat_counts(poa, reads,
                                               pp.repeat_sub_matrix)
        if helen_h5 is not None:
            from margin_tpu.polish import helen
            with io_lock:
                helen.handle_helen_features(
                    feature_type, feature_max_rl, helen_h5,
                    full_feature_output, true_reference_bam, rle_ref, params,
                    chunk.chunk_idx, chunk, poa, reads, tables, use_lut, log)
        if output_poa_csv or output_poa_dot or output_repeat_counts:
            from margin_tpu.polish import outputs
            outputs.write_supplemental_chunk_information(
                output_base, chunk.chunk_idx, chunk, poa, reads, params,
                output_poa_dot, output_poa_csv, output_repeat_counts)
        seq_rec = (chunk.ref_name, chunk.chunk_idx, poa.ref_string.expand())
        with io_lock:
            ckpt.save(chunk.chunk_idx, {
                "seq": seq_rec,
                "rng_state": (None if per_chunk_rng else chunk_rng.getstate())})
        log(f"  chunk {chunk.chunk_idx}: {len(reads)} reads, "
            f"consensus {poa.ref_string.non_rle_length}bp")
        return seq_rec

    if threads == 1:
        reader = bamio.open_alignment(bam_file)
        chunk_seqs = []
        for chunk in my_chunks:
            chunk_rng = (random.Random(f"{seed}:{chunk.chunk_idx}")
                         if per_chunk_rng else rng)
            chunk_seqs.append(process_chunk(chunk, reader, chunk_rng))
        reader.close()
    else:
        # polish.c:475-478 `omp parallel for schedule(dynamic,1)`
        from concurrent.futures import ThreadPoolExecutor
        tls = _threading.local()
        open_readers: list = []

        def worker(chunk):
            reader = getattr(tls, "reader", None)
            if reader is None:
                reader = tls.reader = bamio.open_alignment(bam_file)
                with io_lock:
                    open_readers.append(reader)
            return process_chunk(chunk, reader,
                                 random.Random(f"{seed}:{chunk.chunk_idx}"))

        with ThreadPoolExecutor(max_workers=threads) as pool:
            chunk_seqs = list(pool.map(worker, my_chunks))
        for r in open_readers:
            r.close()
    if ckpt.loaded:
        log(f"> Resumed {ckpt.loaded} of {len(chunkr.chunks)} chunks "
            f"from checkpoint")
    if shard_idx is not None:
        log(f"> Shard {shard_idx}/{shard_n} complete: "
            f"{len(chunk_seqs)} chunks checkpointed; run with --shard merge "
            f"to produce outputs")
        if helen_h5 is not None:
            helen_h5.close()
        return PolishOutputs()
    if helen_h5 is not None:
        helen_h5.close()
        log(f"> Wrote HELEN features to {helen_h5.filename}")

    if mh is not None:
        # the one collective: all-gather each host's (contig, chunk_idx,
        # consensus) records — exactly the OutputChunkers stitch inputs
        # (stitching.c:1573-1588), nothing more, compressed on the wire
        payload = mh.dumps_z(chunk_seqs)
        gathered = mh.allgather_bytes(payload)
        log(f"> Gathered chunk records from {mh.num_hosts()} hosts "
            f"(sent {len(payload)} B, received "
            f"{sum(len(b) for b in gathered)} B)")
        chunk_seqs = [rec for b in gathered for rec in mh.loads_z(b)]
        if mh.host_id() != 0:
            mh.barrier("polish-outputs")
            return PolishOutputs()

    out = PolishOutputs()
    if skip_output_fasta:
        # polish.c --skipOutputFasta: features/supplementary files only
        if ckpt.enabled:
            log(f"> {ckpt.report()}")
        ckpt.finalize()
        log(f"> Finished (skipped FASTA output) in {time.time() - t0:.1f}s")
    else:
        sequences = stitcher.stitch_sequences(chunk_seqs, params)
        out = PolishOutputs(fasta=f"{output_base}.fa", sequences=sequences)
        write_fasta(out.fasta, sequences)
        if ckpt.enabled:
            log(f"> {ckpt.report()}")
        ckpt.finalize()
        log(f"> Wrote polished FASTA {out.fasta} in {time.time() - t0:.1f}s")
    if mh is not None:
        mh.barrier("polish-outputs")
    return out


def run_polish_diploid(bam_file: str, reference_fasta: str, params: Params,
                       output_base: str, region: Optional[str] = None,
                       seed: int = 0, use_lut: bool = False,
                       output_poa_csv: bool = False,
                       output_poa_dot: bool = False,
                       output_repeat_counts: bool = False,
                       output_haplotype_reads: bool = False,
                       output_phasing_state: bool = False,
                       vcf_file: Optional[str] = None,
                       only_use_vcf_alleles: bool = False,
                       skip_output_fasta: bool = False,
                       checkpoint: bool = False,
                       true_reference_bam: Optional[str] = None,
                       shard: Optional[tuple] = None,
                       skip_filtered_reads: bool = False,
                       skip_realignment: bool = False,
                       skip_haplotype_bam: bool = False,
                       threads: int = 1,
                       hosts: Optional[tuple] = None,
                       log=print) -> PolishOutputs:
    """polish_main --diploid (polish.c:620-863): per-chunk bubble phasing +
    per-hap consensus, phased stitching (seam vote + trim both haps),
    phased FASTAs + haplotagged BAM. With `vcf_file`, candidate variant
    positions come from the VCF; `only_use_vcf_alleles` restricts alleles
    to the VCF's (requires non-RLE params and skip_output_fasta,
    polish.c:364-371). hosts=(coordinator, N, host_id): chunk partitioning
    across a jax.distributed group with one gather of (result, hap seqs)
    records; host 0 stitches and writes."""
    bamio.set_cram_reference(reference_fasta)
    from margin_tpu.phase.stitching import ChunkPhaseResult, stitch_next_chunk
    from margin_tpu.polish import diploid as diploidmod
    from margin_tpu.phase.driver import write_haplotagged_bam

    rng = random.Random(seed)
    mh = None
    if hosts is not None:
        from margin_tpu.parallel import multihost as mh
        coordinator, n_hosts, host_id = hosts
        mh.init(coordinator, int(n_hosts), int(host_id))
        log(f"> Multi-host: host {host_id}/{n_hosts} via {coordinator}")
    shard_idx = shard_n = None
    if shard is not None:
        checkpoint = True
        if shard[0] != "merge":
            shard_idx, shard_n = int(shard[0]), int(shard[1])
    t0 = time.time()
    pp = params.polish
    if not skip_filtered_reads and not pp.skipHaploidPolishingIfDiploid:
        # polish.c:361-363: only the filtered-read partition path requires
        # the non-mutating POA; with --skipFilteredReads the reference runs
        # the refining poa_realignAll instead
        raise ValueError("Parameter polish->skipHaploidPolishingIfDiploid "
                         "must be TRUE unless skipFilteredReads is set")
    if only_use_vcf_alleles:
        if pp.useRunLengthEncoding:
            raise ValueError("The --onlyVcfAlleles parameter can only be "
                             "used without runLengthEncoding")
        if not skip_output_fasta:
            raise ValueError("The --onlyVcfAlleles parameter must be used "
                             "with the --skipOutputFasta option")

    vcf_entries_map = None
    if vcf_file is not None:
        from margin_tpu.io.vcf import parse_vcf
        vcf_entries_map = parse_vcf(vcf_file, region,
                                    use_rle=pp.useRunLengthEncoding)

    # polish.c:400: filtered reads are only recorded when they will be
    # partitioned afterwards
    chunkr = chunkermod.construct_chunker(
        bam_file, region, None, pp,
        record_filtered_reads=not skip_filtered_reads)
    log(f"> Built {len(chunkr.chunks)} chunks (diploid)")
    _write_chunks_csv(output_base, chunkr)
    fasta = FastaIndex(reference_fasta)
    tables = pairhmm.PairHmmTables.from_params(
        pp.sm_forward, pp.sm_reverse,
        repeat=pp.repeat_sub_matrix if pp.useRepeatCountsInAlignment else None)

    # multi-chip: shard scoring batches over a ("dp","sp") mesh (SURVEY §2.3)
    from margin_tpu.parallel import executor
    if executor.context().mesh is None and not executor.context().pinned:
        try:
            import jax
            if jax.default_backend() != "cpu" and jax.device_count() > 1:
                executor.enable_mesh(log=log)
        except Exception:
            pass

    from margin_tpu.utils.checkpoint import ChunkCheckpointer
    ckpt = ChunkCheckpointer(
        f"{output_base}.checkpoint", enabled=checkpoint,
        meta={"bam": os.path.abspath(bam_file), "region": region,
              "seed": seed, "diploid": True, "vcf": vcf_file,
              "n_chunks": len(chunkr.chunks),
              "per_chunk_rng": (shard is not None or threads > 1
                                or hosts is not None)},
        log=log)

    threads = max(int(threads), 1)
    per_chunk_rng = shard is not None or threads > 1 or hosts is not None
    my_chunks = [c for c in chunkr.chunks
                 if shard_idx is None or c.chunk_idx % shard_n == shard_idx]
    if mh is not None:
        my_chunks = [c for c in my_chunks
                     if c.chunk_idx % mh.num_hosts() == mh.host_id()]
    import threading as _threading
    io_lock = _threading.Lock()

    def process_chunk(chunk, reader, chunk_rng):
        payload = ckpt.load(chunk.chunk_idx)
        if payload is not None:
            if payload.get("rng_state") is not None:
                chunk_rng.setstate(payload["rng_state"])
            return (payload["res"], payload["hap1_seq"],
                    payload["hap2_seq"])
        rng = chunk_rng
        raw_ref = fasta.fetch(chunk.ref_name, chunk.chunk_overlap_start,
                              chunk.chunk_overlap_end).upper()
        rle_ref = (RleString.encode(raw_ref) if pp.useRunLengthEncoding
                   else RleString.identity(raw_ref))
        reads, alignments, f_reads, f_alns = convert_to_reads_and_alignments(
            chunk, rle_ref, reader, pp, keep_filtered=True)
        if true_reference_bam is not None:
            # chunkTruthHaplotypes_addTruthReadsToFilteredReadSet
            # (misc.c:443-473): truth contigs ride along as filtered reads
            # with CTRID.<chunkIdx>.<name> names and get partitioned with
            # the phased haplotypes
            import copy as _copy
            pp_truth = _copy.copy(pp)
            pp_truth.includeSupplementaryAlignments = True
            truth_reader = bamio.open_alignment(true_reference_bam)
            try:
                t_reads, t_alns, _tf, _tfa = convert_to_reads_and_alignments(
                    chunk, rle_ref, truth_reader, pp_truth,
                    keep_filtered=False)
            finally:
                truth_reader.close()
            for tr in t_reads:
                tr.read_name = f"CTRID.{chunk.chunk_idx}.{tr.read_name}"
            f_reads.extend(t_reads)
            f_alns.extend(t_alns)
        # downsample via full read length (polish.c:544-549)
        if pp.maxDepth > 0 and reads:
            from margin_tpu.phase.downsample import knapsack_probs
            lengths = np.array([r.rle_read.length for r in reads])
            span = chunk.chunk_overlap_end - chunk.chunk_overlap_start
            if lengths.sum() / span >= pp.maxDepth:
                metrics = np.array([r.full_read_length for r in reads])
                probs = knapsack_probs(lengths, metrics, pp.maxDepth, span)
                kept_r, kept_a = [], []
                for r, a, p in zip(reads, alignments, probs):
                    if rng.random() < p:
                        kept_r.append(r)
                        kept_a.append(a)
                    elif not skip_filtered_reads:
                        # polish.c:530: downsampled-out reads only join the
                        # filtered pool when it will be partitioned
                        f_reads.append(r)
                        f_alns.append(a)
                reads, alignments = kept_r, kept_a
        if skip_realignment:
            # polish.c:591-594: CIGAR-string likelihoods only, POA unmutated
            from margin_tpu.polish.poa import poa_realign_only_anchor_alignments
            poa = poa_realign_only_anchor_alignments(reads, alignments,
                                                     rle_ref, pp)
        elif pp.skipHaploidPolishingIfDiploid:
            poa = poa_realign(reads, alignments, rle_ref, pp, tables,
                              use_lut=use_lut)
        else:
            # polish.c:599-601 (reachable only with --skipFilteredReads)
            poa = poa_realign_all(reads, alignments, rle_ref, params, tables,
                                  use_lut)
        chunk_vcf_entries = None
        if vcf_entries_map is not None:
            # polish.c:630-642
            from margin_tpu.phase import variants
            rle_map = (rle_ref.non_rle_to_rle_map()
                       if pp.useRunLengthEncoding else None)
            chunk_vcf_entries, _filtered = variants.get_vcf_entries_for_region(
                vcf_entries_map, chunk.ref_name, chunk.chunk_overlap_start,
                chunk.chunk_overlap_end, params, rng, rle_map=rle_map)
        want_supplemental = (output_poa_csv or output_poa_dot
                             or output_repeat_counts
                             or output_haplotype_reads
                             or output_phasing_state)
        collect = {} if want_supplemental else None
        (hap1_seq, hap2_seq, hap1_names, hap2_names, gf, phreds,
         name_by_id) = diploidmod.diploid_chunk(
            poa, reads, f_reads, f_alns, rle_ref, chunk_vcf_entries, params,
            tables, ref_name=chunk.ref_name, use_lut=use_lut, collect=collect,
            only_vcf_alleles=only_use_vcf_alleles,
            output_fasta=not skip_output_fasta, alignments=alignments,
            chunk=chunk, rng=rng, skip_filtered=skip_filtered_reads,
            skip_realignment=skip_realignment)
        if want_supplemental:
            from margin_tpu.polish import outputs
            # poa_writeSupplementalChunkInformationDiploid
            # (htsIntegration.c:1546-1587)
            for hap_id, key in ((".hap1", "poa_hap1"), (".hap2", "poa_hap2")):
                outputs.write_supplemental_chunk_information(
                    output_base, chunk.chunk_idx, chunk, collect[key], reads,
                    params, output_poa_dot, output_poa_csv,
                    output_repeat_counts, hap_identifier=hap_id)
            if output_haplotype_reads:
                min_phred = params.phase.minPhredScoreForHaplotypePartition
                for hap_id, ids in ((".hap1", collect["hap1_ids"]),
                                    (".hap2", collect["hap2_ids"])):
                    path = outputs._chunk_file_base(
                        output_base, "readIds", chunk.chunk_idx,
                        chunk, hap_id) + ".csv"
                    hap_reads = {r.read_name: phreds.get(id(r), 0.0) or 0.0
                                 for r in reads if id(r) in ids}
                    with open(path, "w") as fh:
                        outputs.write_partition_csv(fh, hap_reads, min_phred)
            if output_phasing_state:
                path = (f"{output_base}.C{chunk.chunk_idx:05d}."
                        f"{chunk.ref_name}-{chunk.chunk_overlap_start}-"
                        f"{chunk.chunk_overlap_end}.phasingInfo.json")
                rle_map = rle_ref.rle_to_non_rle_map()
                with open(path, "w") as fh:
                    fh.write("{\n")
                    outputs.save_bubble_phasing_info(
                        chunk, collect["bg"], gf, collect["hap1_ids"],
                        collect["hap2_ids"], rle_map, fh)
                    outputs.write_phased_read_info_json(
                        chunk, reads, alignments, f_reads, f_alns,
                        collect["hap1_ids"], collect["hap2_ids"],
                        rle_map, fh)
                    fh.write("\n}\n")
        res = ChunkPhaseResult(chunk.chunk_idx, chunk.ref_name)
        for r in reads:
            p = phreds.get(id(r))
            if r.read_name in hap1_names:
                res.hap1_reads[r.read_name] = p if p and p > 0 else -1.0
            elif r.read_name in hap2_names:
                res.hap2_reads[r.read_name] = p if p and p > 0 else -1.0
        for r in f_reads:
            if r.read_name in hap1_names and r.read_name not in res.hap1_reads:
                res.hap1_reads[r.read_name] = -1.0
            elif r.read_name in hap2_names and r.read_name not in res.hap2_reads:
                res.hap2_reads[r.read_name] = -1.0
        with io_lock:
            ckpt.save(chunk.chunk_idx, {
                "res": res, "hap1_seq": hap1_seq, "hap2_seq": hap2_seq,
                "rng_state": (None if per_chunk_rng else rng.getstate())})
        log(f"  chunk {chunk.chunk_idx}: {len(reads)} reads -> "
            f"{len(res.hap1_reads)} hap1 / {len(res.hap2_reads)} hap2; "
            f"consensus {len(hap1_seq)}/{len(hap2_seq)}bp")
        return (res, hap1_seq, hap2_seq)

    chunk_results = []  # (ChunkPhaseResult, hap1_seq, hap2_seq)
    if threads == 1:
        reader = bamio.open_alignment(bam_file)
        for chunk in my_chunks:
            chunk_rng = (random.Random(f"{seed}:{chunk.chunk_idx}")
                         if per_chunk_rng else rng)
            chunk_results.append(process_chunk(chunk, reader, chunk_rng))
        reader.close()
    else:
        from concurrent.futures import ThreadPoolExecutor
        tls = _threading.local()
        open_readers: list = []

        def worker(chunk):
            reader = getattr(tls, "reader", None)
            if reader is None:
                reader = tls.reader = bamio.open_alignment(bam_file)
                with io_lock:
                    open_readers.append(reader)
            return process_chunk(chunk, reader,
                                 random.Random(f"{seed}:{chunk.chunk_idx}"))

        with ThreadPoolExecutor(max_workers=threads) as pool:
            chunk_results = list(pool.map(worker, my_chunks))
        for r in open_readers:
            r.close()
    if ckpt.loaded:
        log(f"> Resumed {ckpt.loaded} of {len(chunkr.chunks)} chunks "
            f"from checkpoint")
    if shard_idx is not None:
        log(f"> Shard {shard_idx}/{shard_n} complete: "
            f"{len(chunk_results)} chunks checkpointed; run with "
            f"--shard merge to produce outputs")
        return PolishOutputs()

    if mh is not None:
        # one gather of the stitch inputs: ChunkPhaseResult (hap read-name
        # maps + switch flags) + the two hap consensus strings per chunk,
        # compressed on the wire
        payload = mh.dumps_z(chunk_results)
        gathered = mh.allgather_bytes(payload)
        log(f"> Gathered chunk records from {mh.num_hosts()} hosts "
            f"(sent {len(payload)} B, received "
            f"{sum(len(b) for b in gathered)} B)")
        chunk_results = [rec for b in gathered for rec in mh.loads_z(b)]
        if mh.host_id() != 0:
            mh.barrier("polish-diploid-outputs")
            return PolishOutputs()

    # phased stitch: vote + swap + trim both hap sequences
    # (mergeContigChunkz, stitching.c:1413-1499)
    out = PolishOutputs()
    hap1_records, hap2_records = [], []
    ids1, ids2 = [], []
    chunk_results.sort(key=lambda t: t[0].chunk_idx)
    i = 0
    while i < len(chunk_results):
        name = chunk_results[i][0].ref_name
        j = i
        acc1 = dict(chunk_results[i][0].hap1_reads)
        acc2 = dict(chunk_results[i][0].hap2_reads)
        prev1, prev2 = chunk_results[i][1], chunk_results[i][2]
        pieces1, pieces2 = [], []
        j += 1
        while j < len(chunk_results) and chunk_results[j][0].ref_name == name:
            res, s1, s2 = chunk_results[j]
            stitch_next_chunk(acc1, acc2, res,
                              params.phase.stitchWithPrimaryReadsOnly)
            if res.was_switched:
                s1, s2 = s2, s1
            if not skip_output_fasta:
                prev1, s1, _ = stitcher.trim_adjacent_sequences(prev1, s1,
                                                                params)
                prev2, s2, _ = stitcher.trim_adjacent_sequences(prev2, s2,
                                                                params)
            pieces1.append(prev1)
            pieces2.append(prev2)
            prev1, prev2 = s1, s2
            j += 1
        pieces1.append(prev1)
        pieces2.append(prev2)
        hap1_records.append((name, "".join(pieces1)))
        hap2_records.append((name, "".join(pieces2)))
        ids1.extend(acc1.keys())
        ids2.extend(acc2.keys())
        i = j

    if not skip_output_fasta:
        out.hap1_fasta = f"{output_base}.hap1.fa"
        out.hap2_fasta = f"{output_base}.hap2.fa"
        write_fasta(out.hap1_fasta, hap1_records)
        write_fasta(out.hap2_fasta, hap2_records)
    if skip_haplotype_bam:
        # polish.c -M/--skipHaplotypeBAM
        out.hap1_count, out.hap2_count = len(set(ids1)), len(set(ids2))
    else:
        out.haplotagged_bam = f"{output_base}.haplotagged.bam"
        h1, h2, h0 = write_haplotagged_bam(bam_file, out.haplotagged_bam,
                                           region, set(ids1), set(ids2),
                                           params)
        out.hap1_count, out.hap2_count = h1, h2
    if true_reference_bam is not None:
        # chunkTruthHaplotypes_print (misc.c:382-440)
        path = f"{output_base}.truthHaplotypesPartition.tsv"
        per_chunk = {c.chunk_idx: ([], []) for c in chunkr.chunks}
        for hap, ids in ((1, ids1), (2, ids2)):
            for name in ids:
                if not name.startswith("CTRID."):
                    continue
                parts = name.split(".")
                ci = int(parts[1])
                per_chunk[ci][hap - 1].append(".".join(parts[2:]))
        with open(path, "w") as fh:
            fh.write("#contig\tstartPos\tendPos\toverlapStart\toverlapEnd"
                     "\thap\tsequenceName\n")
            for c in chunkr.chunks:
                h1_names, h2_names = per_chunk[c.chunk_idx]
                for hap_no, names in ((1, h1_names), (2, h2_names)):
                    for nm in names:
                        fh.write(f"{c.ref_name}\t{c.chunk_start}\t"
                                 f"{c.chunk_end}\t{c.chunk_overlap_start}\t"
                                 f"{c.chunk_overlap_end}\t{hap_no}\t{nm}\n")
        log(f"> Wrote truth haplotype partitioning to {path}")
    if ckpt.enabled:
        log(f"> {ckpt.report()}")
    ckpt.finalize()
    bam_note = ("BAM skipped" if skip_haplotype_bam
                else f"BAM H1 {h1} H2 {h2} H0 {h0}")
    log(f"> Diploid polish done in {time.time() - t0:.1f}s: "
        f"hap lengths {sum(len(s) for _, s in hap1_records)}/"
        f"{sum(len(s) for _, s in hap2_records)}, {bam_note}")
    if mh is not None:
        mh.barrier("polish-diploid-outputs")
    return out
