"""Command line interface: `python -m margin_tpu <command>`.

Parity: margin.c dispatch + phase.c/polish.c argument handling (the
commonly used flags)."""

from __future__ import annotations

import argparse
import os
import sys


def _add_common(p):
    p.add_argument("bam", help="input BAM (indexed)")
    p.add_argument("reference", help="reference FASTA")
    p.add_argument("params", help="parameters JSON (margin-compatible)")
    p.add_argument("-o", "--outputBase", default="output",
                   help="output file prefix [default: output]")
    p.add_argument("-r", "--region", default=None,
                   help="region to process (contig or contig:start-end)")
    p.add_argument("-p", "--maxDepth", type=int, default=-1,
                   help="override maxDepth parameter")
    p.add_argument("--seed", type=int, default=0, help="random seed")
    p.add_argument("--lut-logadd", dest="lut_logadd", action="store_true",
                   default=True,
                   help="use the reference's piecewise-cubic LUT logAdd "
                        "(the default — same flavor as the reference "
                        "binary, and the faster native/kernel path)")
    p.add_argument("--exact-logadd", dest="lut_logadd",
                   action="store_false",
                   help="use exact logaddexp instead of the LUT")
    p.add_argument("--checkpoint", action="store_true",
                   help="persist per-chunk results under "
                        "<outputBase>.checkpoint/ and resume a killed run")
    p.add_argument("--shard", default=None, metavar="I/N|merge",
                   help="multi-process scaling: 'I/N' processes every Nth "
                        "chunk (offset I) into the shared checkpoint dir; "
                        "'merge' combines all shards into final outputs")
    p.add_argument("-a", "--logLevel", default="INFO",
                   choices=["CRITICAL", "INFO", "DEBUG"],
                   help="logging verbosity [default: INFO]")
    p.add_argument("-t", "--threads", type=int, default=1,
                   help="host worker threads over chunks (phase.c/polish.c "
                        "-t). t>1 overlaps host-side chunk work with device "
                        "batches; each chunk then uses its own seeded RNG "
                        "stream (deterministic, but differs from the -t1 "
                        "stream like the reference's threaded runs do)")
    p.add_argument("-k", "--tempFilesToDisk", action="store_true",
                   help="compatibility flag (polish.c -k): maps to "
                        "--checkpoint (per-chunk results go to disk)")
    p.add_argument("--workers", default="thread",
                   choices=["thread", "process"],
                   help="chunk worker kind for -t N: 'thread' shares the "
                        "process (host Python serializes on the GIL but "
                        "overlaps device batches); 'process' runs N CPU "
                        "worker processes with device scoring routed to "
                        "this process over a socket — full host-core "
                        "scaling, byte-identical outputs")
    p.add_argument("--rngMode", default="st", choices=["st", "python"],
                   help="random stream: 'st' replays the reference "
                        "binary's glibc rand() stream exactly (golden "
                        "parity); 'python' uses random.Random(seed)")
    p.add_argument("--hosts", type=int, default=None, metavar="N",
                   help="multi-host scale-out: total number of host "
                        "processes in the jax.distributed group (pair "
                        "with --host-id and --coordinator)")
    p.add_argument("--host-id", type=int, default=None, metavar="I",
                   help="this process's id in the --hosts group (0-based; "
                        "host 0 writes outputs)")
    p.add_argument("--coordinator", default="127.0.0.1:8476",
                   metavar="HOST:PORT",
                   help="jax.distributed coordinator address for --hosts")
    p.add_argument("--profile", action="store_true",
                   help="write structured per-chunk/per-stage timing to "
                        "<outputBase>.profile.json")
    p.add_argument("--jaxTrace", default=None, metavar="DIR",
                   help="wrap the run in a JAX profiler trace written to "
                        "DIR (view with xprof/tensorboard)")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv

    # aux tool dispatch (tools/ executables in the reference)
    if argv and argv[0] == "calcLocalPhasingCorrectness":
        from margin_tpu.tools.lpc import main as lpc_main
        return lpc_main(argv[1:])
    if argv and argv[0] == "tagFromIds":
        from margin_tpu.tools.tag_from_ids import main as tfi_main
        return tfi_main(argv[1:])
    if argv and argv[0] == "tagFromPhasedVcf":
        from margin_tpu.tools.tag_from_phased_vcf import main as tfpv_main
        return tfpv_main(argv[1:])
    if argv and argv[0] == "runLengthMatrix":
        from margin_tpu.tools.run_length_matrix import main as rlm_main
        return rlm_main(argv[1:])

    top = argparse.ArgumentParser(prog="margin_tpu",
                                  description="margin on JAX: phase + polish")
    sub = top.add_subparsers(dest="command", required=True)

    ph = sub.add_parser("phase", help="haplotag reads / phase a VCF")
    _add_common(ph)
    ph.add_argument("vcf", help="VCF with variants to phase")
    ph.add_argument("-M", "--skipHaplotypeBAM", action="store_true")
    ph.add_argument("-V", "--skipPhasedVCF", action="store_true")

    po = sub.add_parser("polish", help="polish an assembly")
    _add_common(po)
    po.add_argument("-2", "--diploid", action="store_true")
    po.add_argument("-v", "--vcf", default=None,
                    help="VCF with variants for diploid phasing")
    po.add_argument("-A", "--onlyVcfAlleles", action="store_true",
                    help="only consider alleles from the VCF (requires "
                         "non-RLE params and --skipOutputFasta)")
    po.add_argument("-T", "--skipOutputFasta", action="store_true",
                    help="skip consensus FASTA output (diploid: only the "
                         "haplotagged BAM and ancillary files are written)")
    po.add_argument("-S", "--skipFilteredReads", action="store_true",
                    help="do NOT haplotype filtered reads (--diploid only; "
                         "polish.c:51)")
    po.add_argument("-R", "--skipRealignment", action="store_true",
                    help="fill the POA from CIGAR likelihoods only, no DP "
                         "realignment (--diploid haplotyping; polish.c:52)")
    po.add_argument("-M", "--skipHaplotypeBAM", action="store_true",
                    help="do not write the haplotagged BAM (--diploid only)")
    # HELEN feature export (polish.c:148-151, 195-219)
    po.add_argument("-f", "--produceFeatures", action="store_true",
                    help="output HELEN features (default type splitRleWeight)")
    po.add_argument("-F", "--featureType", default=None,
                    help="simpleWeight | splitRleWeight | channelRleWeight")
    po.add_argument("-L", "--splitRleWeightMaxRL", type=int, default=0,
                    help="max run length for RLE feature types [default 10]")
    po.add_argument("-u", "--trueReferenceBam", default=None,
                    help="truth assembly aligned to the reference, for "
                         "HELEN feature labels")
    po.add_argument("--fullFeatureOutput", action="store_true",
                    help="also write per-chunk consensus FASTAs")
    # supplementary outputs (polish.c:77-80, 154-161)
    po.add_argument("-c", "--supplementaryChunks", action="store_true",
                    help="compatibility flag (polish.c -c): per-chunk "
                         "supplementary files are written whenever any of "
                         "-d/-i/-j/-n/-s is set (the reference additionally "
                         "requires -c; here it is accepted and implied)")
    po.add_argument("-C", "--supplementaryChunksOnly", action="store_true",
                    help=argparse.SUPPRESS)  # vestigial in polish.c (no case)
    po.add_argument("-i", "--outputRepeatCounts", action="store_true",
                    help="write per-chunk repeat count observations as CSV")
    po.add_argument("-j", "--outputPoaCsv", action="store_true",
                    help="write per-chunk POA as CSV")
    po.add_argument("-d", "--outputPoaDot", action="store_true",
                    help="write per-chunk POA as DOT")
    po.add_argument("-n", "--outputHaplotypeReads", action="store_true",
                    help="write phased reads and likelihoods as CSV "
                         "(--diploid only)")
    po.add_argument("-s", "--outputPhasingState", action="store_true",
                    help="write phasing likelihoods as JSON (--diploid only)")

    args = top.parse_args(argv)

    if args.tempFilesToDisk:
        args.checkpoint = True
    if (args.command == "phase" and args.skipHaplotypeBAM
            and args.skipPhasedVCF):
        top.error("With --skipHaplotypeBAM and --skipPhasedVCF there "
                  "will be no output.")
    for path, desc in [(args.bam, "bam"), (args.reference, "reference fasta"),
                       (args.params, "params")]:
        if not os.path.exists(path):
            top.error(f"Could not read from input {desc} file: {path}")
    if args.command == "polish":
        if args.vcf is not None and not os.path.exists(args.vcf):
            top.error(f"Could not read from vcf file: {args.vcf}")
        if args.onlyVcfAlleles and not args.skipOutputFasta:
            top.error("The --onlyVcfAlleles parameter must be used with "
                      "the --skipOutputFasta option")
        if args.skipOutputFasta and (args.outputPoaCsv
                                     or args.outputRepeatCounts
                                     or args.outputPoaDot):
            # polish.c:313-314
            top.error("Cannot --outputPoaCsv, --outputRepeatCounts, or "
                      "--outputPoaDot with --skipOutputFasta")
        # polish.c:216-219, 301-307: validate feature flags up front
        if args.splitRleWeightMaxRL < 0:
            top.error(f"Invalid splitRleWeightMaxRL: {args.splitRleWeightMaxRL}")
        if args.trueReferenceBam is not None:
            if not os.path.exists(args.trueReferenceBam):
                top.error("Could not read from truth file: "
                          f"{args.trueReferenceBam}")
            if not os.path.exists(args.trueReferenceBam + ".bai"):
                top.error("BAM does not appear to be indexed: "
                          f"{args.trueReferenceBam}")

    # Backend: the one JAX selects (JAX_PLATFORMS=cpu asks for the CPU).
    # A backend that fails to start is an error, never a silent fall back
    # to the CPU. Skipped when (a) this process is an IPC scoring worker
    # (device work rides the socket to the parent, and the worker stays
    # jax-free) or (b) --hosts is set (jax.distributed must initialize
    # before anything touches the backend; run_phase does it).
    is_ipc_worker = bool(os.environ.get("MARGIN_TPU_SCORE_SERVER"))
    if not is_ipc_worker and getattr(args, "hosts", None) is None:
        import jax

        from margin_tpu.utils import compile_cache
        jax.devices()
        compile_cache.configure()
    # worker processes spawned by --workers process route their device
    # scoring back to the parent over a socket
    from margin_tpu.parallel.ipc import maybe_install_client
    maybe_install_client()

    from margin_tpu.params import Params
    params = Params.load(args.params)
    if args.maxDepth >= 0:
        params.polish.maxDepth = args.maxDepth

    shard = None
    if args.shard is not None:
        if args.shard == "merge":
            shard = ("merge",)
        else:
            try:
                i_s, n_s = args.shard.split("/")
                shard = (int(i_s), int(n_s))
            except ValueError:
                top.error(f"Invalid --shard (want I/N or merge): "
                          f"{args.shard}")

    # CRITICAL silences per-chunk progress lines (the reference's
    # --logLevel); DEBUG and INFO both print them here
    log = (lambda *a: None) if args.logLevel == "CRITICAL" else print

    from margin_tpu.utils import profiling
    profiler = profiling.Profiler(enabled=args.profile)
    trace_ctx = profiling.maybe_jax_trace(args.jaxTrace)

    def write_profile():
        """Fold any process-worker profiles back in, then write. Workers
        write to MARGIN_TPU_PROFILE_OUT (set by run_process_workers) and
        must NOT glob-merge their siblings' files — only the parent
        (no profile-out override) does the merge."""
        worker_out = os.environ.get("MARGIN_TPU_PROFILE_OUT")
        if worker_out is None:
            import glob
            for wp in sorted(
                    glob.glob(f"{args.outputBase}.profile.worker*.json")):
                profiler.merge_file(wp)
                try:
                    os.remove(wp)
                except OSError:
                    pass
        profiler.write(worker_out or f"{args.outputBase}.profile.json")

    # polish process workers: each worker is a standalone CPU shard process
    # (banded FB runs on the worker's native/scan CPU path; pair scoring
    # rides the socket to this device-owning parent like phase), followed by
    # the ordinary shard-merge pass. polish.c:475-478's omp-for, GIL-free.
    polish_process = (args.command == "polish" and args.workers == "process"
                      and args.threads > 1 and shard is None)

    if args.command == "phase":
        threads = args.threads
        if args.workers == "process" and args.threads > 1 and shard is None:
            # CPU worker processes fill the checkpoint dir (scoring comes
            # back here over the socket); then run the ordinary merge pass
            from margin_tpu.parallel.ipc import run_process_workers
            wargv = ["phase", args.bam, args.reference, args.params,
                     args.vcf, "-o", args.outputBase,
                     "--seed", str(args.seed), "--rngMode", args.rngMode,
                     "-a", "CRITICAL", "-t", "1"]
            if args.region:
                wargv += ["-r", args.region]
            if args.maxDepth >= 0:
                wargv += ["-p", str(args.maxDepth)]
            if not args.lut_logadd:
                wargv += ["--exact-logadd"]
            run_process_workers(wargv, args.threads, args.outputBase,
                                resume=args.checkpoint, log=log,
                                profile=args.profile)
            shard = ("merge",)
            threads = 1
        hosts = None
        if args.hosts is not None:
            if args.host_id is None:
                top.error("--hosts requires --host-id")
            hosts = (args.coordinator, args.hosts, args.host_id)
        from margin_tpu.phase.driver import run_phase
        with trace_ctx:
            run_phase(args.bam, args.reference, args.vcf, params,
                      args.outputBase,
                      region=args.region, write_bam=not args.skipHaplotypeBAM,
                      write_vcf=not args.skipPhasedVCF, seed=args.seed,
                      use_lut=args.lut_logadd, checkpoint=args.checkpoint,
                      shard=shard, profiler=profiler,
                      rng_mode=args.rngMode, threads=threads, hosts=hosts,
                      log=log)
        write_profile()
    elif args.command == "polish":
        threads = args.threads
        if polish_process:
            from margin_tpu.parallel.ipc import run_process_workers
            # the worker command is this invocation minus the worker/thread
            # flags (all other polish flags pass through verbatim)
            skip_with_value = {"--workers", "-t", "--threads", "--jaxTrace"}
            wargv, it = [], iter(argv)
            for tok in it:
                if tok in skip_with_value:
                    next(it, None)
                    continue
                if tok == "--profile":
                    continue
                wargv.append(tok)
            wargv += ["-t", "1", "-a", "CRITICAL"]
            run_process_workers(wargv, args.threads, args.outputBase,
                                resume=args.checkpoint, log=log,
                                profile=args.profile)
            shard = ("merge",)
            threads = 1
        hosts = None
        if args.hosts is not None:
            if args.host_id is None:
                top.error("--hosts requires --host-id")
            hosts = (args.coordinator, args.hosts, args.host_id)
        from margin_tpu.polish.driver import run_polish
        feature_type = args.featureType
        if feature_type is None and args.produceFeatures:
            feature_type = "splitRleWeight"  # polish.c:333-335
        with trace_ctx:
            run_polish(args.bam, args.reference, params, args.outputBase,
                   region=args.region, diploid=args.diploid, seed=args.seed,
                   feature_type=feature_type,
                   feature_max_rl=args.splitRleWeightMaxRL,
                   true_reference_bam=args.trueReferenceBam,
                   full_feature_output=args.fullFeatureOutput,
                   output_poa_csv=args.outputPoaCsv,
                   output_poa_dot=args.outputPoaDot,
                   output_repeat_counts=args.outputRepeatCounts,
                   output_haplotype_reads=args.outputHaplotypeReads,
                   output_phasing_state=args.outputPhasingState,
                   vcf_file=args.vcf,
                   only_use_vcf_alleles=args.onlyVcfAlleles,
                   skip_output_fasta=args.skipOutputFasta,
                   skip_filtered_reads=args.skipFilteredReads,
                   skip_realignment=args.skipRealignment,
                   skip_haplotype_bam=args.skipHaplotypeBAM,
                   checkpoint=args.checkpoint, shard=shard,
                   profiler=profiler, threads=threads, hosts=hosts,
                   log=log)
        write_profile()
        profiler.log_summary(log)
    return 0


if __name__ == "__main__":
    sys.exit(main())
