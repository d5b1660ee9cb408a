"""Seeded inputs for `phase` and `polish`: genomes, haplotypes, ONT-like
reads, and their truth.

Everything is generated from one seed, so the same seed gives the same
bytes. Reads are aligned by construction (their CIGARs are the truth),
so no aligner is needed.

  * `random_genome`: a reference with homopolymers, tandem repeats and
    diverged segmental duplicates.
  * `apply_edits`: a haplotype as the base sequence plus edits (SNVs,
    insertions, deletions), with the map from haplotype to base positions.
  * `simulate_reads`: ONT-like reads from both strands: lognormal lengths
    (mean about 15 kb), substitutions, indels and run-length (homopolymer)
    errors; CIGARs against the base sequence.
  * `write_dataset`: FASTA (+ .fai), coordinate-sorted BAM + BAI, a VCF of
    the het sites and `truth.json` (each read's haplotype, the het sites).
  * `phase_dataset` / `polish_dataset`: the two deployments `chip_smoke.py`
    and the tests run; `write_params`: the checked-in parameter file.

    python -m margin_tpu.testing.simulate phase OUT_DIR [--span N] [--depth X]
    python -m margin_tpu.testing.simulate polish OUT_DIR [--span N] [--depth X]
    python -m margin_tpu.testing.simulate params   # rewrites PARAMS_PATH
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from dataclasses import dataclass, field

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
PARAMS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "params", "ont_sim.json")

# CIGAR op codes (BAM)
OP_M, OP_I, OP_D, OP_S = 0, 1, 2, 4


@dataclass
class ErrorModel:
    """Per-base read error rates (ONT R9.4-like, ~91% identity)."""
    sub: float = 0.03
    ins: float = 0.02
    dele: float = 0.03
    # per homopolymer run of length >= 3: its length is read one off
    run_length: float = 0.15
    mean_length: float = 15000.0
    sigma: float = 0.6          # lognormal shape of read lengths
    min_length: int = 500


@dataclass
class Haplotype:
    seq: np.ndarray        # uint8 codes 0..3
    base_of: np.ndarray    # int64: base position of each hap base, -1 = inserted
    gap_before: np.ndarray  # int64: base bases deleted just before each hap base


@dataclass
class Read:
    name: str
    hap: int
    pos: int
    reverse: bool
    cigar: np.ndarray      # (n, 2) [op, length]
    seq: bytes


@dataclass
class Dataset:
    contig: str
    base: np.ndarray                   # the sequence reads are aligned to
    haps: list                         # [Haplotype]
    reads: list = field(default_factory=list)
    het_sites: list = field(default_factory=list)  # (pos, ref, alt, hap)


# --------------------------------------------------------------------------
# sequences
# --------------------------------------------------------------------------

def random_genome(rng, length: int) -> np.ndarray:
    """uint8 codes: i.i.d. bases at 41% GC, then homopolymers (1 per
    150 bp, length 3-12), tandem repeats (1 per 5 kb, unit 2-6 bp x 4-15)
    and segmental duplicates (1 per 100 kb, 1-3 kb at 1% divergence)."""
    p = [0.295, 0.205, 0.205, 0.295]
    g = rng.choice(4, size=length, p=p).astype(np.uint8)
    n_hp = length // 150
    starts = rng.integers(0, max(1, length - 12), n_hp)
    lens = rng.integers(3, 13, n_hp)
    for s, ln in zip(starts, lens):
        g[s:s + ln] = g[s]
    for _ in range(length // 5000):
        unit = rng.integers(0, 4, int(rng.integers(2, 7))).astype(np.uint8)
        rep = np.tile(unit, int(rng.integers(4, 16)))
        s = int(rng.integers(0, max(1, length - len(rep))))
        g[s:s + len(rep)] = rep[:length - s]
    for _ in range(length // 100_000):
        ln = int(rng.integers(1000, 3001))
        if length < 3 * ln:
            break
        src = int(rng.integers(0, length - ln))
        dst = int(rng.integers(0, length - ln))
        seg = g[src:src + ln].copy()
        mut = rng.random(ln) < 0.01
        seg[mut] = (seg[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
        g[dst:dst + ln] = seg
    return g


def apply_edits(base: np.ndarray, edits) -> Haplotype:
    """edits: (pos, kind, payload) with kind "snv" (payload: new code),
    "ins" (payload: codes inserted after pos) or "del" (payload: length
    deleted from pos). Edits must not overlap."""
    n = len(base)
    keep = np.ones(n, bool)
    seq = base.copy()
    ins_after: dict = {}
    for pos, kind, payload in sorted(edits, key=lambda e: e[0]):
        if kind == "snv":
            seq[pos] = payload
        elif kind == "ins":
            ins_after[pos] = np.asarray(payload, np.uint8)
        else:
            keep[pos:pos + payload] = False
    counts = keep.astype(np.int64)
    ins_pos = np.array(sorted(ins_after), dtype=np.int64)
    for p in ins_pos:
        counts[p] += len(ins_after[p])
    out = np.empty(int(counts.sum()), np.uint8)
    base_of = np.full(len(out), -1, np.int64)
    ends = np.cumsum(counts)
    first = ends - counts
    kept = np.nonzero(keep)[0]
    out[first[kept]] = seq[kept]
    base_of[first[kept]] = kept
    for p in ins_pos:
        o = first[p] + int(keep[p])
        out[o:o + len(ins_after[p])] = ins_after[p]
    mapped = np.nonzero(base_of >= 0)[0]
    gap_before = np.zeros(len(out), np.int64)
    prev = np.concatenate([[-1], base_of[mapped][:-1]])
    gap_before[mapped] = base_of[mapped] - prev - 1
    if len(mapped):
        gap_before[mapped[0]] = 0
    return Haplotype(out, base_of, gap_before)


def het_edits(rng, base: np.ndarray, rate: float, indel_frac: float,
              spacing: int = 20):
    """Het variants at about `rate` per base, each on one haplotype:
    returns [(pos, kind, payload, hap)]. Indels are 1-4 bp; sites are at
    least `spacing` bp apart so their edits never overlap."""
    n = rng.binomial(len(base) - 2 * spacing, rate)
    pos = np.unique(rng.integers(spacing, len(base) - spacing, n))
    pos = pos[np.diff(pos, prepend=-spacing) >= spacing]
    out = []
    for p in pos:
        p = int(p)
        hap = int(rng.integers(0, 2))
        r = rng.random()
        if r >= indel_frac:
            out.append((p, "snv", int((base[p] + rng.integers(1, 4)) % 4),
                        hap))
        elif r < indel_frac / 2:
            out.append((p, "ins", rng.integers(0, 4, int(rng.integers(1, 5)))
                        .astype(np.uint8), hap))
        else:
            out.append((p + 1, "del", int(rng.integers(1, 5)), hap))
    return out


def draft_edits(rng, base: np.ndarray, rate: float, spacing: int = 20):
    """Corrections that turn a draft into its true haplotype, at about
    `rate` per base: 70% homopolymer length changes, 20% SNVs, 10% 1-3 bp
    indels (a long-read assembly's error mix)."""
    n = rng.binomial(len(base) - 2 * spacing, rate)
    pos = np.unique(rng.integers(spacing, len(base) - spacing, n))
    pos = pos[np.diff(pos, prepend=-spacing) >= spacing]
    out = []
    for p in pos:
        p = int(p)
        r = rng.random()
        if r < 0.7:
            if rng.random() < 0.5:
                out.append((p, "ins", np.array([base[p]], np.uint8)))
            else:
                out.append((p, "del", 1))
        elif r < 0.9:
            out.append((p, "snv", int((base[p] + rng.integers(1, 4)) % 4)))
        elif r < 0.95:
            out.append((p, "ins", rng.integers(0, 4, int(rng.integers(1, 4)))
                        .astype(np.uint8)))
        else:
            out.append((p, "del", int(rng.integers(1, 4))))
    return out


# --------------------------------------------------------------------------
# reads
# --------------------------------------------------------------------------

def _runs_last_index(seq: np.ndarray, min_len: int):
    """Index of the last base of every homopolymer run of >= min_len."""
    change = np.nonzero(np.diff(seq.astype(np.int16)) != 0)[0]
    starts = np.concatenate([[0], change + 1])
    ends = np.concatenate([change, [len(seq) - 1]])
    sel = (ends - starts + 1) >= min_len
    return ends[sel]


def simulate_read(rng, hap: Haplotype, s: int, e: int, err: ErrorModel):
    """One read of hap[s:e] (s mapped to the base). Returns (pos, cigar,
    seq codes) against the base sequence."""
    seq = hap.seq[s:e]
    n = len(seq)
    keep = rng.random(n) >= err.dele
    ins = rng.geometric(1.0 - err.ins, n) - 1
    ins_char = rng.integers(0, 4, n).astype(np.uint8)
    base = seq.copy()
    sub = rng.random(n) < err.sub
    base[sub] = (base[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    run_end = _runs_last_index(seq, 3)
    hit = run_end[rng.random(len(run_end)) < err.run_length]
    grow = rng.random(len(hit)) < 0.5
    ins[hit[grow]] += 1
    ins_char[hit[grow]] = seq[hit[grow]]
    keep[hit[~grow]] = False
    keep[0] = True
    base[0] = seq[0]

    mapped = hap.base_of[s:e] >= 0
    gap = hap.gap_before[s:e].copy()
    gap[0] = 0
    op1 = np.where(mapped, np.where(keep, OP_M, OP_D), OP_I)
    n1 = np.where(mapped | keep, 1, 0)
    codes = np.stack([np.full(n, OP_D), op1, np.full(n, OP_I)], axis=1)
    cnts = np.stack([gap, n1, ins], axis=1)
    ops = np.repeat(codes.ravel(), cnts.ravel())
    read = np.repeat(np.stack([base, ins_char], axis=1).ravel(),
                     np.stack([keep.astype(np.int64), ins], axis=1).ravel())
    # trim to the first and last match: leading/trailing insertions become
    # soft clips, deletions there are dropped
    m = np.nonzero(ops == OP_M)[0]
    a, b = int(m[0]), int(m[-1])
    lead, tail = ops[:a], ops[b + 1:]
    pos = int(hap.base_of[s]) + int((lead == OP_D).sum())
    core = ops[a:b + 1]
    change = np.nonzero(np.diff(core) != 0)[0]
    starts = np.concatenate([[0], change + 1])
    lens = np.diff(np.concatenate([starts, [len(core)]]))
    cigar = np.stack([core[starts], lens], axis=1)
    sl, st = int((lead == OP_I).sum()), int((tail == OP_I).sum())
    if sl:
        cigar = np.concatenate([[[OP_S, sl]], cigar])
    if st:
        cigar = np.concatenate([cigar, [[OP_S, st]]])
    return pos, cigar.astype(np.int64), read


def simulate_reads(rng, haps, depth: float, err: ErrorModel, prefix="read"):
    """Reads at total `depth`, split evenly over the haplotypes."""
    reads = []
    for h, hap in enumerate(haps):
        in_span = np.nonzero(hap.base_of >= 0)[0]
        span_lo, span_hi = int(in_span[0]), int(in_span[-1]) + 1
        span = span_hi - span_lo
        target = depth / len(haps) * span
        mu = np.log(err.mean_length) - err.sigma ** 2 / 2
        total = 0
        while total < target:
            ln = int(max(err.min_length, rng.lognormal(mu, err.sigma)))
            start = int(rng.integers(span_lo - ln + err.min_length,
                                     span_hi - err.min_length))
            s, e = max(start, span_lo), min(start + ln, span_hi)
            # start on a base-mapped haplotype position
            k = np.searchsorted(in_span, s)
            if k >= len(in_span) or in_span[k] >= e - 10:
                continue
            s = int(in_span[k])
            pos, cigar, codes = simulate_read(rng, hap, s, e, err)
            reads.append(Read("", h, pos, bool(rng.integers(0, 2)), cigar,
                              BASES[codes].tobytes()))
            total += e - s
    reads.sort(key=lambda r: (r.pos, r.hap))
    for i, r in enumerate(reads):
        r.name = f"{prefix}{i:06d}"
    return reads


# --------------------------------------------------------------------------
# deployments
# --------------------------------------------------------------------------

def phase_dataset(seed: int, span: int = 1_000_000, depth: float = 50.0,
                  het_rate: float = 1e-3, err: ErrorModel | None = None,
                  contig: str = "sim1") -> Dataset:
    """`phase`: a reference, two haplotypes with het SNVs (1/1000) and 10%
    small indels, reads from both at `depth`."""
    rng = np.random.default_rng(seed)
    ref = random_genome(rng, span)
    hets = het_edits(rng, ref, het_rate, indel_frac=0.1)
    haps = [apply_edits(ref, [e[:3] for e in hets if e[3] == h])
            for h in (0, 1)]
    ds = Dataset(contig, ref, haps, het_sites=hets)
    ds.reads = simulate_reads(rng, haps, depth, err or ErrorModel())
    return ds


def polish_dataset(seed: int, span: int = 110_000, depth: float = 40.0,
                   draft_error_rate: float = 0.01, het_rate: float = 1e-3,
                   err: ErrorModel | None = None,
                   contig: str = "draft1") -> Dataset:
    """`polish`: a draft whose true haplotypes differ from it by assembly
    errors (`draft_edits`, 1% by default: an unpolished long-read
    assembly) shared by both haplotypes plus het variants;
    reads from both haplotypes at `depth`, aligned to the draft. The het
    sites are reported against the draft."""
    rng = np.random.default_rng(seed)
    draft = random_genome(rng, span)
    fixes = draft_edits(rng, draft, draft_error_rate)
    taken = np.zeros(span + 64, bool)
    for p, kind, payload in fixes:
        taken[max(0, p - 10):p + 10] = True
    hets = [h for h in het_edits(rng, draft, het_rate, indel_frac=0.1)
            if not taken[h[0]]]
    haps = [apply_edits(draft, fixes + [e[:3] for e in hets if e[3] == h])
            for h in (0, 1)]
    ds = Dataset(contig, draft, haps, het_sites=hets)
    ds.reads = simulate_reads(rng, haps, depth, err or ErrorModel())
    return ds


# --------------------------------------------------------------------------
# files
# --------------------------------------------------------------------------

def _write_fasta(path, name, codes):
    seq = BASES[codes].tobytes().decode()
    with open(path, "w") as fh:
        fh.write(f">{name}\n")
        for i in range(0, len(seq), 60):
            fh.write(seq[i:i + 60] + "\n")
    with open(path + ".fai", "w") as fh:
        fh.write(f"{name}\t{len(seq)}\t{len(name) + 2}\t60\t61\n")


def _vcf_record(base, pos, kind, payload):
    """(POS 1-based, REF, ALT) of one edit against `base`."""
    b = BASES
    if kind == "snv":
        return pos + 1, chr(b[base[pos]]), chr(b[payload])
    if kind == "ins":
        return (pos + 1, chr(b[base[pos]]),
                chr(b[base[pos]]) + b[payload].tobytes().decode())
    anchor = pos - 1
    return (anchor + 1, b[base[anchor:pos + payload]].tobytes().decode(),
            chr(b[base[anchor]]))


def write_dataset(ds: Dataset, out_dir: str) -> dict:
    """Write reference.fa(+.fai), reads.bam(+.bai), variants.vcf and
    truth.json under out_dir; returns their paths."""
    from margin_tpu.io import bam as bamio
    from margin_tpu.io.cram import build_bam_record

    os.makedirs(out_dir, exist_ok=True)
    paths = {k: os.path.join(out_dir, v) for k, v in (
        ("fasta", "reference.fa"), ("bam", "reads.bam"),
        ("vcf", "variants.vcf"), ("truth", "truth.json"))}
    _write_fasta(paths["fasta"], ds.contig, ds.base)
    n = len(ds.base)
    header = bamio.BamHeader(
        f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:{ds.contig}\tLN:{n}\n"
        "@RG\tID:sim\tSM:SIM\n",
        [ds.contig], [n])
    with bamio.BamWriter(paths["bam"], header) as bw:
        for r in ds.reads:
            qual = bytes([20]) * len(r.seq)
            rec = build_bam_record(r.name, 16 if r.reverse else 0, 0, r.pos,
                                   60, r.cigar, r.seq, qual, b"")
            bw.write_raw(rec.raw)
    bamio.build_bai(paths["bam"])
    with open(paths["vcf"], "w") as fh:
        fh.write("##fileformat=VCFv4.2\n"
                 f"##contig=<ID={ds.contig},length={n}>\n"
                 '##FORMAT=<ID=GT,Number=1,Type=String,Description='
                 '"Genotype">\n'
                 "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                 "SIM\n")
        for pos, kind, payload, _hap in ds.het_sites:
            p1, ref, alt = _vcf_record(ds.base, pos, kind, payload)
            fh.write(f"{ds.contig}\t{p1}\t.\t{ref}\t{alt}\t60\tPASS\t.\t"
                     "GT\t0/1\n")
    truth = {
        "contig": ds.contig,
        "read_hap": {r.name: r.hap for r in ds.reads},
        "het_sites": [[int(_vcf_record(ds.base, p, k, v)[0]), int(h)]
                      for p, k, v, h in ds.het_sites],
        "haplotypes": [BASES[h.seq].tobytes().decode() for h in ds.haps],
    }
    with open(paths["truth"], "w") as fh:
        json.dump(truth, fh)
    return paths


def hap_segment(ds: Dataset, h: int, lo: int, hi: int) -> str:
    """The part of haplotype h whose base positions lie in [lo, hi)."""
    hap = ds.haps[h]
    m = np.nonzero((hap.base_of >= lo) & (hap.base_of < hi))[0]
    return BASES[hap.seq[m[0]:m[-1] + 1]].tobytes().decode()


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------

ASSUMED = [
    "alignment HMM: StateMachineParams.default_nucleotide "
    "(stateMachine.c:612-622 constants), not trained",
    "phase and polish blocks: the dataclass defaults of margin_tpu/params.py",
    "chunk geometry and depth limits from Margin's documented defaults "
    "(base_params.json): chunkSize 100000, chunkBoundary 10000, maxDepth 64, "
    "excessiveDepthThreshold 256",
    "maxPoaConsensusIterations 3 (the dataclass default 0 leaves polish to "
    "the bubble pass alone, which drops read-supported bases on simulated "
    "data)",
    "skipHaploidPolishingIfDiploid true, which --diploid requires unless "
    "skipFilteredReads is set (polish.c)",
    "run-length encoding on; the repeat-count matrix is estimated by "
    "tools/run_length_matrix.py from simulated reads aligned to their "
    "true haplotype (margin_tpu.testing.simulate, seed 7), with add-one "
    "smoothing",
]


def _hmm_json() -> dict:
    """default_nucleotide as the JSON trained-HMM block (symmetric type 2:
    transitions are probabilities [from][to], emissions 16 match + 4 + 4)."""
    from margin_tpu.params import StateMachineParams
    sm = StateMachineParams.default_nucleotide()
    e = np.exp
    T = np.zeros((3, 3))
    T[0] = [e(sm.t_match_continue), e(sm.t_gap_open_x), e(sm.t_gap_open_y)]
    T[1] = [e(sm.t_match_from_gap_x), e(sm.t_gap_extend_x),
            e(sm.t_gap_switch_to_y)]
    T[2] = [e(sm.t_match_from_gap_y), e(sm.t_gap_switch_to_x),
            e(sm.t_gap_extend_y)]
    em = np.concatenate([e(sm.match_probs[:4, :4]).ravel(),
                         e(sm.gap_x_probs[:4]), e(sm.gap_y_probs[:4])])
    return {"type": 2, "emissionsType": 0,
            "transitions": [float(v) for v in T.ravel()],
            "emissions": [float(v) for v in em]}


def base_params(repeat_block: dict | None = None) -> dict:
    doc = {
        "assumed": ASSUMED,
        "polish": {
            "useRunLengthEncoding": True,
            "chunkSize": 100000,
            "chunkBoundary": 10000,
            "maxDepth": 64,
            "excessiveDepthThreshold": 256,
            "maxPoaConsensusIterations": 3,
            "skipHaploidPolishingIfDiploid": True,
            "hmmForwardStrandReadGivenReference": _hmm_json(),
        },
        "phase": {},
    }
    if repeat_block is not None:
        doc["polish"]["repeatCountSubstitutionMatrix"] = repeat_block
    return doc


def _repeat_block(counts: np.ndarray) -> dict:
    """counts[base, underlying, observed] -> the JSON block of log10
    P(observed | underlying, base) (add-one smoothing; row 0 unused) and
    the log10 priors of underlying run lengths."""
    n = counts.shape[1]
    block = {}
    c = counts.astype(np.float64) + 1.0
    probs = c / c.sum(axis=2, keepdims=True)
    for b, letter in enumerate("ACGT"):
        block[f"repeatCountLogProbabilities_{letter}_F"] = [
            round(float(v), 6) for v in np.log10(probs[b]).ravel()]
    under = counts.sum(axis=2) + 1.0
    for key, bases in (("baseLogRepeatCounts_AT", (0, 3)),
                       ("baseLogRepeatCounts_GC", (1, 2))):
        u = under[list(bases)].sum(axis=0)
        block[key] = [round(float(v), 6) for v in np.log10(u / u.sum())]
    assert n == 51
    return block


def write_params(path: str = PARAMS_PATH, seed: int = 7, work_dir=None):
    """Estimate the repeat-count matrix from a simulated dataset whose
    reads are aligned to their true haplotype, and write the params JSON."""
    import tempfile

    from margin_tpu.tools import run_length_matrix

    work = work_dir or tempfile.mkdtemp(prefix="sim_params_")
    rng = np.random.default_rng(seed)
    hap = apply_edits(random_genome(rng, 300_000), [])
    ds = Dataset("truth1", hap.seq, [hap])
    ds.reads = simulate_reads(rng, [hap], 30.0, ErrorModel())
    paths = write_dataset(ds, work)
    boot = os.path.join(work, "boot.json")
    with open(boot, "w") as fh:
        json.dump({k: v for k, v in base_params().items()
                   if k != "assumed"}, fh)
    base = os.path.join(work, "rl")
    run_length_matrix.main([paths["bam"], paths["fasta"], boot, "-o", base])
    counts = np.zeros((4, 51, 51))
    for b, letter in enumerate("ACGT"):
        rows = np.loadtxt(f"{base}.run_lengths.{letter}.tsv", skiprows=1,
                          ndmin=2)
        counts[b, 1:, 1:] = rows[:, 1:]
    doc = base_params(_repeat_block(counts))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        fh.write(_dumps_rows(doc) + "\n")
    return path


def _dumps_rows(doc) -> str:
    """JSON with every list of numbers on lines of at most 51 values (one
    row of a repeat-count matrix), everything else indented."""
    def enc(v, ind):
        pad = " " * ind
        if isinstance(v, dict):
            items = [f'{pad} {json.dumps(k)}: {enc(x, ind + 1)}'
                     for k, x in v.items()]
            return "{\n" + ",\n".join(items) + f"\n{pad}}}"
        if isinstance(v, list) and v and all(
                isinstance(x, (int, float)) for x in v):
            rows = [", ".join(json.dumps(x) for x in v[i:i + 51])
                    for i in range(0, len(v), 51)]
            if len(rows) == 1:
                return "[" + rows[0] + "]"
            return ("[\n" + ",\n".join(f"{pad}  {r}" for r in rows)
                    + f"\n{pad}]")
        if isinstance(v, list):
            return ("[\n" + ",\n".join(f"{pad}  {json.dumps(x)}"
                                          for x in v) + f"\n{pad}]")
        return json.dumps(v)
    return enc(doc, 0)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="margin_tpu.testing.simulate")
    ap.add_argument("kind", choices=["phase", "polish", "params"])
    ap.add_argument("out", nargs="?", default=None)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--span", type=int, default=None)
    ap.add_argument("--depth", type=float, default=None)
    args = ap.parse_args(argv)
    if args.kind == "params":
        print(write_params(args.out or PARAMS_PATH))
        return 0
    kw = {k: v for k, v in (("span", args.span), ("depth", args.depth))
          if v is not None}
    make = phase_dataset if args.kind == "phase" else polish_dataset
    paths = write_dataset(make(args.seed, **kw), args.out)
    print(json.dumps(paths))
    return 0


if __name__ == "__main__":
    sys.exit(main())
