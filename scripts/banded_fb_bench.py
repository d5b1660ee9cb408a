"""Banded forward-backward: the Triton kernel against the plain lax.scan
that XLA compiles and the native C++ kernel, on synthetic problems.

    python scripts/banded_fb_bench.py --case 6144x16x64 --case 200001x16x8
    python scripts/banded_fb_bench.py --polish-e2e 30000

A case is DEPTHxWIDTHxCOUNT: COUNT problems of DEPTH anti-diagonals in the
WIDTH band bucket (margin_tpu.testing.fb_parity.make_items). For each case
the script prints one JSON line: cold (first call, compiles included) and
warm (best of --reps) wall seconds per path, and the kernel's parity with
the native kernel under the bounds of `fb_parity.bounds_for_depth`.
`--polish-e2e SPAN` times whole haploid polish runs with either path.
Needs a GPU; `--interpret` runs the kernel on the CPU at toy sizes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402


def _timed(fn, reps):
    t0 = time.perf_counter()
    out = fn()
    cold = time.perf_counter() - t0
    warm = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        warm.append(time.perf_counter() - t0)
    return out, cold, (min(warm) if warm else None)


def run_case(tables, depth, width, count, reps, scan, interpret,
             use_lut=True, seed=0):
    from margin_tpu.ops import banded
    from margin_tpu.testing import fb_parity

    rng = np.random.default_rng(seed)
    items, expansion = fb_parity.make_items(rng, count, depth, width)
    thr = 0.01
    row = {"depth": depth, "width": width, "count": count}

    def device():
        res, n_native = banded.posteriors_many_device(
            tables, items, expansion, thr, use_lut, False,
            interpret=interpret)
        return res, n_native

    (dev, n_native), row["triton_cold_s"], row["triton_warm_s"] = _timed(
        device, reps)
    row["routed_native"] = n_native
    nat, row["native_cold_s"], row["native_warm_s"] = _timed(
        lambda: banded._solve_native_items(tables, items, expansion, thr,
                                           use_lut, False), min(reps, 1))
    if scan:
        _, row["scan_cold_s"], row["scan_warm_s"] = _timed(
            lambda: banded._posteriors_many_scan(tables, items, expansion,
                                                 thr, use_lut, False), reps)
    post_b, tot_b = fb_parity.bounds_for_depth(depth)
    cmp = [fb_parity.compare(a, b, thr, post_b, tot_b)
           for a, b in zip(dev, nat)]
    row["parity"] = {
        "post_bound": post_b, "total_rel_bound": tot_b,
        "max_abs_post": max(c["max_abs_post"] for c in cmp),
        "max_total_rel": max(c["total_rel"] for c in cmp),
        "flips": sum(c["flips"] for c in cmp),
        "bad_flips": sum(c["bad_flips"] for c in cmp),
        "ok": all(c["ok"] for c in cmp)}
    row["band_cells"] = int(sum(banded._true_band_cells(
        banded._item_geom(it, expansion, False)) for it in items))
    return row


def polish_e2e(span: int, depth: float, order: str, seed: int = 2):
    """Haploid `polish` wall time through cli.main with each device FB in
    turn (`order`, e.g. "triton,scan,scan,triton"), on one seeded draft.
    Returns one row per run; the first run of each path includes its
    compiles."""
    import tempfile

    from margin_tpu.cli import main as cli_main
    from margin_tpu.ops import banded
    from margin_tpu.testing import simulate

    work = tempfile.mkdtemp(prefix="fb_e2e_")
    paths = simulate.write_dataset(
        simulate.polish_dataset(seed, span=span, depth=depth), work)
    rows, seen = [], set()
    on_gpu = banded.use_device_fb
    try:
        for i, kind in enumerate(order.split(",")):
            # the scan runs: the GPU backend takes the CPU's path
            banded.use_device_fb = on_gpu if kind == "triton" else (
                lambda: False)
            t0 = time.perf_counter()
            cli_main(["polish", paths["bam"], paths["fasta"],
                      simulate.PARAMS_PATH, "-o", f"{work}/{kind}{i}",
                      "-t", "2", "-a", "CRITICAL"])
            rows.append({"polish_span": span, "depth": depth, "fb": kind,
                         "first_of_kind": kind not in seen,
                         "wall_s": time.perf_counter() - t0})
            seen.add(kind)
    finally:
        banded.use_device_fb = on_gpu
    outs = {open(f"{work}/{r['fb']}{i}.fa").read()
            for i, r in enumerate(rows)}
    for r in rows:
        r["outputs_identical"] = len(outs) == 1
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--case", action="append", default=[],
                    help="DEPTHxWIDTHxCOUNT (repeatable)")
    ap.add_argument("--polish-e2e", type=int, default=0, metavar="SPAN",
                    help="also time haploid polish of a SPAN-bp draft with "
                         "the kernel and with the scan, in turns")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--scan", action="store_true",
                    help="also time the lax.scan path")
    ap.add_argument("--interpret", action="store_true",
                    help="run the kernel in interpret mode (CPU)")
    ap.add_argument("--out", default=None, help="also append rows here")
    args = ap.parse_args(argv)

    import jax

    from margin_tpu.ops import pairhmm
    from margin_tpu.params import StateMachineParams

    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.interpret:
        sys.exit("banded_fb_bench: no GPU (use --interpret on the CPU)")
    tables = pairhmm.PairHmmTables.from_params(
        StateMachineParams.default_nucleotide())
    ok = True
    for case in args.case:
        depth, width, count = (int(v) for v in case.split("x"))
        row = run_case(tables, depth, width, count, args.reps, args.scan,
                       args.interpret)
        row["device"] = {"platform": dev.platform, "kind": dev.device_kind}
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "a") as fh:
                fh.write(line + "\n")
        ok &= row["parity"]["ok"]
    if args.polish_e2e:
        for row in polish_e2e(args.polish_e2e, 40.0,
                              "triton,scan,scan,triton"):
            line = json.dumps(row)
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as fh:
                    fh.write(line + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
