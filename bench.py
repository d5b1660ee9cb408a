"""Benchmark: end-to-end `margin phase` and `margin polish` throughput on
one GPU, plus the dense pair-HMM kernel, on seeded simulated inputs
(margin_tpu.testing.simulate; the parameters are the checked-in
margin_tpu/testing/params/ont_sim.json).

Modes (MARGIN_TPU_BENCH, default "all"):
  phase   : 1 Mb contig at 50x, 10 chunks, -t 10; variant sites/s, kb/s
  polish  : haploid polish of a 110 kb draft at 40x; polished bases/s
  diploid : diploid polish of a 20 kb window of it
  kernel  : batched forward_total throughput (the phase hot kernel)
Each end-to-end mode runs twice in-process: cold (compiles included) and
warm. The CPU baselines (BASELINE.md) are context, not a comparison on
equal hardware:
  phase : whole-genome 75x ONT, 80 min on a 64-thread host
          -> 3.1 Gb / 4800 s = ~645 kb/s for the whole host
  polish: ~350 CPU.h per Gb (docs/MarginPolish.md:155)
          -> 64-thread host = 1e9 / (350/64 * 3600) = ~50.8 kb/s
Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "extra"},
with the device (platform, kind, count) and the card's name and power
limit in extra. Needs a GPU: without one it exits non-zero.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

BASELINE_PHASE_KBPS = 3.1e6 / (80 * 60)          # ~645.8 kb/s, 64 threads
BASELINE_POLISH_BPS = 1e9 / (350.0 / 64 * 3600)  # ~50.8 kb/s, 64 threads


def _twice(argv):
    """cli.main cold then warm; returns (walls, warm device stats)."""
    from margin_tpu.cli import main
    from margin_tpu.parallel.executor import DEVICE_STATS

    walls = []
    for _ in range(2):
        DEVICE_STATS.reset()
        t0 = time.perf_counter()
        main(argv + ["--logLevel", "CRITICAL"])
        walls.append(time.perf_counter() - t0)
    return walls, DEVICE_STATS.snapshot()


def bench_phase(work, span=1_000_000, depth=50.0, threads=10):
    from margin_tpu.testing import simulate

    p = simulate.write_dataset(simulate.phase_dataset(1, span=span,
                                                      depth=depth),
                               os.path.join(work, "phase"))
    out = os.path.join(work, "phase", "out")
    walls, dev = _twice(["phase", p["bam"], p["fasta"], simulate.PARAMS_PATH,
                         p["vcf"], "-o", out, "-t", str(threads)])
    hets = 0
    with open(f"{out}.phased.vcf") as fh:
        for line in fh:
            if not line.startswith("#"):
                gt = line.rstrip("\n").split("\t")[9].split(":")[0]
                hets += gt in ("0|1", "1|0")
    return {"kb_per_s": span / 1000.0 / walls[1],
            "het_sites_per_s": hets / walls[1], "phased_hets": hets,
            "wall_cold_s": walls[0], "wall_warm_s": walls[1],
            "span_kb": span / 1000.0, "depth": depth, "threads": threads,
            "device_stats": dev}


def bench_polish(work, span=110_000, depth=40.0, diploid_window=None):
    from margin_tpu.testing import simulate

    ds = simulate.polish_dataset(2, span=span, depth=depth)
    p = simulate.write_dataset(ds, os.path.join(work, "polish"))
    argv = ["polish", p["bam"], p["fasta"], simulate.PARAMS_PATH,
            "-o", os.path.join(work, "polish", "out")]
    bases = span
    if diploid_window:
        argv += ["--diploid", "-r", f"{ds.contig}:1-{diploid_window}"]
        bases = diploid_window
    else:
        argv += ["-t", "2"]
    walls, dev = _twice(argv)
    return {"bases_per_s": bases / walls[1], "bases": bases,
            "wall_cold_s": walls[0], "wall_warm_s": walls[1],
            "depth": depth, "device_stats": dev}


def bench_kernel():
    """Batched dense pair-HMM forward throughput, one host readback per
    launch (what a pipeline can extract), median of 3 repeats."""
    from margin_tpu.ops import pairhmm
    from margin_tpu.params import StateMachineParams

    rng = np.random.default_rng(0)
    B, LX, LY = 131072, 29, 32
    tables = pairhmm.PairHmmTables.from_params(
        StateMachineParams.default_nucleotide())
    batches = []
    for _ in range(4):
        pairs = [(rng.integers(0, 4, LX).astype(np.uint8),
                  rng.integers(0, 4, LY).astype(np.uint8))
                 for _ in range(B)]
        batches.append(pairhmm.make_batch(
            pairs, strands=rng.integers(0, 2, B).astype(np.int32)))
    np.asarray(pairhmm.forward_total(tables, batches[0], use_lut=True))
    n_iter, reps = 8, []
    for _ in range(3):
        t0 = time.perf_counter()
        for i in range(n_iter):
            np.asarray(pairhmm.forward_total(
                tables, batches[i % len(batches)], use_lut=True))
        reps.append(time.perf_counter() - t0)
    dt = float(np.median(reps))
    return {"pairs_per_s": B * n_iter / dt, "batch": B,
            "pair_shape": [LX, LY], "repeat_s": reps}


def main():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import jax

    from margin_tpu.utils import compile_cache

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"bench.py: no GPU (JAX found {devs[0].platform})")
    compile_cache.configure()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu")).stdout.strip()
    mode = os.environ.get("MARGIN_TPU_BENCH", "all")
    work = tempfile.mkdtemp(prefix="margin_bench_")
    extra = {"device": {"platform": devs[0].platform,
                        "kind": devs[0].device_kind, "count": len(devs)},
             "card": card}
    if mode in ("all", "kernel"):
        extra["kernel"] = bench_kernel()
    if mode in ("all", "polish"):
        extra["polish"] = bench_polish(work)
    if mode in ("all", "diploid"):
        extra["diploid"] = bench_polish(work, diploid_window=20_000)
    if mode in ("all", "phase"):
        extra["phase"] = bench_phase(work)
        value, unit = extra["phase"]["kb_per_s"], "kb/s"
        vs = value / BASELINE_PHASE_KBPS
        metric = "phase_kb_per_s_warm"
    elif "polish" in extra or "diploid" in extra:
        key = "polish" if "polish" in extra else "diploid"
        value, unit = extra[key]["bases_per_s"], "bases/s"
        vs = value / BASELINE_POLISH_BPS
        metric = f"{key}_bases_per_s_warm"
    else:
        value, unit, vs = extra["kernel"]["pairs_per_s"], "pairs/s", None
        metric = "forward_total_pairs_per_s"
    print(json.dumps({"metric": metric, "value": value, "unit": unit,
                      "vs_baseline": vs, "extra": extra}, default=float))


if __name__ == "__main__":
    main()
