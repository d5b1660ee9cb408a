#!/usr/bin/env python3
"""Smoke test of margin_tpu's main path on an NVIDIA GPU.

    python chip_smoke.py               # one card, all phases
    python chip_smoke.py --four-cards  # phase + haploid polish on 4 cards,
                                       # each against the same run on 1 card

Phases (one card):
  1. device: JAX's first device must be a GPU;
  2. native: the four host engines build from native/*.cc and load;
  3. parity: every device kernel of the path against its plain reference
     at real widths (tolerances in PARITY below);
  4. phase: `python -m margin_tpu phase` (through cli.main) on a seeded
     1 Mb contig at 50x (10 chunks, ~1000 het sites), checked against the
     simulated truth;
  5. polish: haploid `polish` of one production chunk (100 kb core plus
     its 10 kb boundary, 110 kb of draft) at 40x, checked against the
     truth haplotypes;
  6. diploid: `polish --diploid` on a 20 kb window of the same data (cut
     for time), checked likewise.

Each phase prints one line `SMOKE {...}` with its numbers: wall seconds
cold (compiles included) and warm, device calls, banded items routed to
the native host kernel, and the card's name and power limit. Any failure
raises and exits non-zero. The last line is the JSON result the driver
reads. Inputs are generated from --seed under sim_data/ (git-ignored).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# --- fixed thresholds -------------------------------------------------------
PARITY = {
    # forward_total (float32, LUT logAdd) vs the float64 oracle
    "forward_total_abs": 1e-3,
    # banded FB posteriors vs the native kernel (both float32):
    # fb_parity.bounds_for_depth (2e-3 up to 8k diagonals, 1e-2 up to 64k,
    # 5e-2 beyond; totals 1e-5 relative). Vs the float64 oracle at ~2k
    # diagonals: fb_parity.oracle_bounds (posteriors within 5e-5 x |total|,
    # totals 5e-5 relative: float32 rounding of log-space sums)
}
TRUTH = {
    "haplotag_accuracy": 0.95,      # per phase set, pooled
    "phased_het_recall": 0.60,
    "phased_genotype_accuracy": 0.95,
    # haploid polish: identity to the closer true haplotype at least this
    # and strictly above the draft's; diploid: the mean identity of the
    # two polished haplotypes (best pairing) strictly above the draft's
    "polish_min_identity": 0.99,
}
PHASE_SPAN, PHASE_DEPTH = 1_000_000, 50.0
POLISH_SPAN, POLISH_DEPTH = 110_000, 40.0
DIPLOID_WINDOW = 20_000
# --four-cards: spans cut (same depths) so that four cards' time stays
# small; the comparison is of outputs, not of speed
FOUR_CARD_PHASE_SPAN, FOUR_CARD_POLISH_SPAN = 300_000, 40_000


def _sub_env():
    # subprocesses never take the card
    return dict(os.environ, JAX_PLATFORMS="cpu")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, env=_sub_env()).stdout.strip().splitlines()[0]


class Smoke:
    def __init__(self, seed: int, work: str):
        self.seed = seed
        self.work = work
        self.card = card()

    def line(self, phase: str, **kw):
        kw = {"phase": phase, **kw, "card": self.card}
        print("SMOKE " + json.dumps(kw, default=float), flush=True)

    # -- 1 ------------------------------------------------------------------
    def device(self):
        import jax
        d = jax.devices()[0]
        if d.platform != "gpu":
            raise SystemExit(f"chip_smoke: no GPU (JAX found {d.platform})")
        from margin_tpu.utils import compile_cache
        self.line("device", kind=d.device_kind, count=len(jax.devices()),
                  jax=jax.__version__, compile_cache=compile_cache.configure())
        return d

    # -- 2 ------------------------------------------------------------------
    def native(self):
        from margin_tpu.utils import native_build
        t0 = time.perf_counter()
        for name in ("marginio", "marginfb", "marginrp", "marginpoa"):
            if native_build.load(name) is None:
                raise RuntimeError(f"native/lib{name}.so did not build/load")
        flags = ""
        with open("/proc/cpuinfo") as fh:
            for ln in fh:
                if ln.startswith("flags"):
                    flags = " ".join(sorted(f for f in ln.split()[2:]
                                            if f.startswith(("avx", "sse4",
                                                             "fma", "bmi"))))
                    break
        cxx = subprocess.run(["g++", "--version"], capture_output=True,
                             text=True, env=_sub_env()).stdout.splitlines()[0]
        self.line("native", build_s=time.perf_counter() - t0,
                  cpu_flags=flags, compiler=cxx, cores=os.cpu_count())

    # -- 3 ------------------------------------------------------------------
    def parity(self):
        for name, check in (("forward_total", self._parity_forward_total),
                            ("banded_fb", self._parity_banded),
                            ("rphmm_device", self._parity_rphmm)):
            t0 = time.perf_counter()
            out = check()
            self.line(f"parity_{name}", wall_s=time.perf_counter() - t0,
                      result=out)

    def _parity_forward_total(self):
        """4096 (read substring, allele) pairs of 30-90 bp as phase scores
        them: alleles from a simulated genome, reads from the ONT-like
        error model, both strands, ragged ends mixed in."""
        from margin_tpu.ops import pairhmm
        from margin_tpu.params import StateMachineParams
        from margin_tpu.testing import oracle, simulate

        rng = np.random.default_rng(self.seed)
        genome = simulate.random_genome(rng, 200_000)
        err = simulate.ErrorModel()
        pairs = []
        for _ in range(4096):
            n = int(rng.integers(30, 91))
            s = int(rng.integers(0, len(genome) - n))
            allele = genome[s:s + n]
            hap = simulate.apply_edits(allele, [])
            _pos, _cig, read = simulate.simulate_read(rng, hap, 0, n, err)
            pairs.append((read.astype(np.uint8), allele))
        strands = rng.integers(0, 2, len(pairs))
        rl = rng.random(len(pairs)) < 0.25
        rr = rng.random(len(pairs)) < 0.25
        sm = StateMachineParams.default_nucleotide()
        rv = sm.reverse_complement()
        tables = pairhmm.PairHmmTables.from_params(sm, rv)
        batch = pairhmm.make_batch(pairs, strands=strands, ragged_left=rl,
                                   ragged_right=rr)
        dev = np.asarray(pairhmm.forward_total(tables, batch, use_lut=True),
                         np.float64)[:len(pairs)]
        ref = oracle.oracle_forward_total_batch(sm, rv, pairs, strands, rl,
                                                rr)
        err_abs = float(np.max(np.abs(dev - ref)))
        if not err_abs <= PARITY["forward_total_abs"]:
            raise AssertionError(f"forward_total vs oracle: {err_abs}")
        return {"pairs": len(pairs), "max_abs": err_abs,
                "bound": PARITY["forward_total_abs"]}

    def _parity_banded(self):
        from margin_tpu.ops import banded, pairhmm
        from margin_tpu.params import StateMachineParams
        from margin_tpu.testing import fb_parity, oracle

        sm = StateMachineParams.default_nucleotide()
        tables = pairhmm.PairHmmTables.from_params(sm)
        rng = np.random.default_rng(self.seed + 1)
        rows = []
        for depth, count in ((6144, 32), (30001, 8), (200001, 2)):
            for width in (16, 32, 64, 128):
                items, exp = fb_parity.make_items(rng, count, depth, width)
                dev, n_native = banded.posteriors_many_device(
                    tables, items, exp, 0.01, True, False)
                nat = banded._solve_native_items(tables, items, exp, 0.01,
                                                 True, False)
                pb, tb = fb_parity.bounds_for_depth(depth)
                cmp = [fb_parity.compare(a, b, 0.01, pb, tb)
                       for a, b in zip(dev, nat)]
                row = {"depth": depth, "width": width, "count": count,
                       "routed_native": n_native, "post_bound": pb,
                       "total_rel_bound": tb,
                       "max_abs_post": max(c["max_abs_post"] for c in cmp),
                       "max_total_rel": max(c["total_rel"] for c in cmp),
                       "flips": sum(c["flips"] for c in cmp)}
                rows.append(row)
                if n_native or not all(c["ok"] for c in cmp):
                    raise AssertionError(f"banded FB vs native: {row}")
        # the float64 oracle at ~2k diagonals
        for width in (16, 32):
            items, exp = fb_parity.make_items(rng, 1, 2001, width)
            it = items[0]
            dev, _ = banded.posteriors_many_device(tables, [it], exp, 0.01,
                                                   True, False)
            m, gx, gy, tot = oracle.oracle_posteriors(
                oracle.OracleStateMachine(sm), it["x_sym"], it["y_sym"],
                it["anchors"], exp)
            ref = (tuple(np.array([(int(p * 1e7), x, y) for p, x, y in v],
                                  np.int64).reshape(-1, 3)
                         for v in (m, gx, gy)), tot)
            pb, tb = fb_parity.oracle_bounds(tot)
            c = fb_parity.compare(dev[0], ref, 0.01, pb, tb)
            rows.append({"depth": 2001, "width": width, "vs": "oracle",
                         "post_bound": pb, "total": tot,
                         "max_abs_post": c["max_abs_post"],
                         "total_rel": c["total_rel"], "flips": c["flips"]})
            if not c["ok"]:
                raise AssertionError(f"banded FB vs oracle: {c}")
        return rows

    def _parity_rphmm(self):
        """Device read-partition FB vs phase/rphmm.py at depth 64:
        integer-valued under maxNotSumTransitions, so bit-identical."""
        from margin_tpu.params import PhaseParams
        from margin_tpu.phase import rphmm_device
        from margin_tpu.phase.bubbles import ProfileSeq, Reference, Site
        from margin_tpu.phase.rphmm import get_rp_hmms

        rng = np.random.default_rng(self.seed + 2)
        sites, off = [], 0
        for _ in range(24):
            a = int(rng.integers(2, 4))
            sites.append(Site(a, off, rng.integers(0, 30, a).astype(np.uint16),
                              rng.integers(0, 90, (a, a)).astype(np.uint16)))
            off += a
        ref = Reference("t", sites, off)
        offsets = ref.allele_offsets()
        seqs = []
        for i in range(64):
            s = int(rng.integers(0, 6))
            e = int(rng.integers(18, len(sites) + 1))
            probs = rng.integers(0, 64, int(offsets[e] - offsets[s]))
            seqs.append(ProfileSeq(None, f"r{i}", s, e - s, int(offsets[s]),
                                   probs.astype(np.uint8)))
        params = PhaseParams(maxNotSumTransitions=True,
                             minPartitionsInAColumn=16,
                             maxPartitionsInAColumn=64,
                             minPosteriorProbabilityForPartition=0.001)
        n_cols = 0
        for hmm in get_rp_hmms(seqs, ref, params):
            hmm.forward_backward()
            host = [np.array(c.forward) for c in hmm.columns] + \
                [np.array(c.backward) for c in hmm.columns]
            os.environ["MARGIN_TPU_RPHMM"] = "device"
            try:
                rphmm_device.forward_backward_device(hmm)
            finally:
                os.environ.pop("MARGIN_TPU_RPHMM", None)
            dev = [np.array(c.forward) for c in hmm.columns] + \
                [np.array(c.backward) for c in hmm.columns]
            for a, b in zip(host, dev):
                np.testing.assert_array_equal(a, b)
            n_cols += len(hmm.columns)
        return {"reads": 64, "columns": n_cols, "bound": 0}

    # -- data ---------------------------------------------------------------
    def phase_data(self, span=None):
        from margin_tpu.testing import simulate
        t0 = time.perf_counter()
        ds = simulate.phase_dataset(self.seed, span=span or PHASE_SPAN,
                                    depth=PHASE_DEPTH)
        paths = simulate.write_dataset(ds, os.path.join(self.work, "phase"))
        return paths, time.perf_counter() - t0

    def polish_data(self, span=None):
        from margin_tpu.testing import simulate
        t0 = time.perf_counter()
        ds = simulate.polish_dataset(self.seed + 1, span=span or POLISH_SPAN,
                                     depth=POLISH_DEPTH)
        paths = simulate.write_dataset(ds, os.path.join(self.work, "polish"))
        return ds, paths, time.perf_counter() - t0

    def _run_cli(self, argv, runs=2):
        """cli.main twice (cold, warm). Returns (walls, device calls of the
        warm run, banded items routed to the native kernel in it)."""
        from margin_tpu.cli import main
        from margin_tpu.ops import banded
        from margin_tpu.parallel.executor import DEVICE_STATS

        walls = []
        for _ in range(runs):
            DEVICE_STATS.reset()
            n0 = banded._FB_FUNNEL.n_native
            t0 = time.perf_counter()
            rc = main(argv + ["-a", "CRITICAL"])
            walls.append(time.perf_counter() - t0)
            if rc not in (0, None):
                raise RuntimeError(f"cli {argv[0]} returned {rc}")
            calls = DEVICE_STATS.snapshot()
            routed = banded._FB_FUNNEL.n_native - n0
        return walls, calls, routed

    # -- 4 ------------------------------------------------------------------
    def phase(self, threads: int = 10):
        from margin_tpu.testing import truth

        paths, setup_s = self.phase_data()
        out = os.path.join(self.work, "phase", "out")
        walls, calls, routed = self._run_cli(
            ["phase", paths["bam"], paths["fasta"], PARAMS_PATH(),
             paths["vcf"], "-o", out, "-t", str(threads)])
        t = truth.load_truth(paths["truth"])
        tag = truth.haplotag_accuracy(f"{out}.haplotagged.bam",
                                      f"{out}.phaseset.bed", t)
        het = truth.phased_het_stats(f"{out}.phased.vcf",
                                     f"{out}.phaseset.bed", t)
        self.line("phase", span=PHASE_SPAN, depth=PHASE_DEPTH,
                  setup_s=setup_s, wall_cold_s=walls[0], wall_warm_s=walls[1],
                  device_calls=calls["launches"], pairs=calls["pairs"],
                  host_kernel_items=routed, haplotag=tag, hets=het)
        if not (tag["accuracy"] >= TRUTH["haplotag_accuracy"]
                and het["recall"] >= TRUTH["phased_het_recall"]
                and het["genotype_accuracy"]
                >= TRUTH["phased_genotype_accuracy"]):
            raise AssertionError(f"phase truth check failed: {tag} {het}")

    # -- 5, 6 ---------------------------------------------------------------
    def polish(self, ds, paths, setup_s, threads: int = 2):
        from margin_tpu.testing import truth

        out = os.path.join(self.work, "polish", "hap")
        walls, calls, routed = self._run_cli(
            ["polish", paths["bam"], paths["fasta"], PARAMS_PATH(),
             "-o", out, "-t", str(threads)])
        t = truth.load_truth(paths["truth"])
        pol = list(truth.read_fasta(f"{out}.fa").values())[0]
        draft = list(truth.read_fasta(paths["fasta"]).values())[0]
        ident = max(truth.identity(pol, h) for h in t["haplotypes"])
        ident0 = max(truth.identity(draft, h) for h in t["haplotypes"])
        self.line("polish", span=POLISH_SPAN, depth=POLISH_DEPTH,
                  setup_s=setup_s, wall_cold_s=walls[0], wall_warm_s=walls[1],
                  device_calls=calls["launches"], host_kernel_items=routed,
                  identity=ident, draft_identity=ident0)
        if not (ident > ident0 and ident >= TRUTH["polish_min_identity"]):
            raise AssertionError(f"polish truth check: {ident} vs {ident0}")

    def diploid(self, ds, paths, threads: int = 1):
        from margin_tpu.testing import simulate, truth

        out = os.path.join(self.work, "polish", "dip")
        walls, calls, routed = self._run_cli(
            ["polish", paths["bam"], paths["fasta"], PARAMS_PATH(),
             "-o", out, "-t", str(threads), "--diploid",
             "-r", f"{ds.contig}:1-{DIPLOID_WINDOW}"])
        hs = [simulate.hap_segment(ds, h, 0, DIPLOID_WINDOW) for h in (0, 1)]
        pol = [list(truth.read_fasta(f"{out}.hap{i}.fa").values())[0]
               for i in (1, 2)]
        draft = list(truth.read_fasta(paths["fasta"]).values())[0]
        draft = draft[:DIPLOID_WINDOW]
        straight = [truth.identity(pol[0], hs[0]), truth.identity(pol[1],
                                                                  hs[1])]
        swapped = [truth.identity(pol[0], hs[1]), truth.identity(pol[1],
                                                                 hs[0])]
        ident = max(straight, swapped, key=sum)
        ident0 = [truth.identity(draft, h) for h in hs]
        self.line("diploid", window=DIPLOID_WINDOW, depth=POLISH_DEPTH,
                  wall_cold_s=walls[0], wall_warm_s=walls[1],
                  device_calls=calls["launches"], host_kernel_items=routed,
                  identity=ident, draft_identity=ident0)
        if not sum(ident) > sum(ident0):
            raise AssertionError(f"diploid truth check: {ident} vs {ident0}")

    # -- four cards ---------------------------------------------------------
    def four_cards(self):
        """phase and haploid polish with the executor mesh over 4 cards,
        each against the same run pinned to one card, byte for byte."""
        import jax

        from margin_tpu.cli import main
        from margin_tpu.parallel import executor

        n = len(jax.devices())
        if n < 4:
            raise SystemExit(f"chip_smoke --four-cards: {n} device(s)")
        ppaths, _ = self.phase_data(FOUR_CARD_PHASE_SPAN)
        ds, lpaths, _ = self.polish_data(FOUR_CARD_POLISH_SPAN)
        runs = {
            "phase": (["phase", ppaths["bam"], ppaths["fasta"], PARAMS_PATH(),
                       ppaths["vcf"], "-t", "10"],
                      ("phased.vcf", "phaseset.bed", "haplotagged.bam")),
            "polish": (["polish", lpaths["bam"], lpaths["fasta"],
                        PARAMS_PATH(), "-t", "2"], ("fa",)),
        }
        for name, (argv, suffixes) in runs.items():
            walls = {}
            for cards in (1, 4):
                if cards == 1:
                    executor.disable_mesh(pin=True)
                else:
                    executor.enable_mesh(4)
                out = os.path.join(self.work, f"{name}_{cards}card")
                t0 = time.perf_counter()
                main(argv + ["-o", out, "-a", "CRITICAL"])
                walls[cards] = time.perf_counter() - t0
            executor.disable_mesh()
            same = {}
            for suf in suffixes:
                with open(os.path.join(self.work, f"{name}_1card.{suf}"),
                          "rb") as fa, open(os.path.join(
                              self.work, f"{name}_4card.{suf}"), "rb") as fb:
                    same[suf] = fa.read() == fb.read()
            peak = [(d.memory_stats() or {}).get("peak_bytes_in_use")
                    for d in jax.devices()[:4]]
            self.line(f"{name}_4cards", span=(FOUR_CARD_PHASE_SPAN
                                              if name == "phase" else
                                              FOUR_CARD_POLISH_SPAN),
                      wall_1card_s=walls[1],
                      wall_4cards_s=walls[4], identical=same,
                      peak_bytes_per_device=peak)
            if not all(same.values()):
                raise AssertionError(f"{name}: 4-card outputs differ {same}")


def PARAMS_PATH():
    from margin_tpu.testing.simulate import PARAMS_PATH as p
    return p


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run phase and haploid polish on 4 cards against "
                         "1 card (needs 4 GPUs)")
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(HERE, "margin_tpu")):
        print("chip_smoke: run from a margin_tpu checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import jax

    work = os.path.join(HERE, "sim_data", "smoke")
    os.makedirs(work, exist_ok=True)
    s = Smoke(args.seed, work)
    dev = s.device()
    s.native()
    if args.four_cards:
        s.four_cards()
        count = 4
    else:
        s.parity()
        s.phase()
        ds, paths, setup_s = s.polish_data()
        s.polish(ds, paths, setup_s)
        s.diploid(ds, paths)
        count = len(jax.devices())
    print(s.card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
