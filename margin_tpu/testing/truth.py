"""Checks of `phase` and `polish` outputs against the simulated truth
(`margin_tpu.testing.simulate`).

phase:
  * haplotag accuracy: within each phase set (phaseset.bed), the share of
    haplotagged reads (HP:1/HP:2) whose tag agrees with their true
    haplotype under the better of the two labelings; pooled over phase
    sets, weighted by reads;
  * phased-het recall: the share of true het sites written as phased
    (`0|1` / `1|0`);
  * phased-genotype accuracy: within each phase set, the share of phased
    het sites whose orientation matches the truth under the better
    labeling.
polish:
  * identity of a sequence to the truth: 1 - edit distance / truth length,
    from a banded global edit distance (`edit_distance`).
"""

from __future__ import annotations

import json

import numpy as np


def _phase_sets(bed_path: str):
    sets = []
    with open(bed_path) as fh:
        for line in fh:
            f = line.split("\t")
            if len(f) >= 3:
                sets.append((f[0], int(f[1]), int(f[2])))
    return sets


def _set_of(sets, contig: str, pos: int) -> int:
    for i, (c, s, e) in enumerate(sets):
        if c == contig and s <= pos < e:
            return i
    return -1


def haplotag_accuracy(bam_path: str, bed_path: str, truth: dict) -> dict:
    from margin_tpu.io.bam import BamReader, _iter_tags

    sets = _phase_sets(bed_path)
    counts: dict = {}  # phase set -> [agree, disagree]
    tagged = total = 0
    with BamReader(bam_path) as r:
        for rec in r:
            if rec.is_secondary or rec.is_supplementary:
                continue
            total += 1
            blob = rec.tags_blob()
            hp = None
            for tag, _typ, start, end in _iter_tags(blob):
                if tag == b"HP":
                    hp = int.from_bytes(blob[start + 3:end], "little")
            if hp not in (1, 2):
                continue
            tagged += 1
            mid = rec.pos + rec.reference_span() // 2
            ps = _set_of(sets, truth["contig"], mid)
            c = counts.setdefault(ps, [0, 0])
            c[int((hp - 1) != truth["read_hap"][rec.name])] += 1
    good = sum(max(a, d) for a, d in counts.values())
    n = sum(a + d for a, d in counts.values())
    return {"accuracy": good / max(n, 1), "tagged": tagged, "reads": total,
            "phase_sets": len(counts)}


def phased_het_stats(vcf_path: str, bed_path: str, truth: dict) -> dict:
    sets = _phase_sets(bed_path)
    hap_of = {int(p): int(h) for p, h in truth["het_sites"]}
    phased: dict = {}
    with open(vcf_path) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            f = line.rstrip("\n").split("\t")
            pos, gt = int(f[1]), f[9].split(":")[0]
            if gt in ("0|1", "1|0") and pos in hap_of:
                # allele 1 on the first haplotype <=> truth hap 0 carries it
                phased[pos] = int(gt == "0|1")
    per_set: dict = {}
    for pos, first_ref in phased.items():
        ps = _set_of(sets, truth["contig"], pos - 1)
        c = per_set.setdefault(ps, [0, 0])
        c[int(first_ref != hap_of[pos])] += 1
    good = sum(max(a, d) for a, d in per_set.values())
    return {"recall": len(phased) / max(len(hap_of), 1),
            "phased": len(phased), "het_sites": len(hap_of),
            "genotype_accuracy": good / max(len(phased), 1)}


def edit_distance(a: str, b: str, band: int = 256) -> int:
    """Global edit distance of a and b within a band of +-`band` around
    the length-scaled diagonal (exact when the optimal path stays in the
    band). Row-vectorized: the in-row insertion chain is a running minimum
    of (value - column) plus column."""
    x = np.frombuffer(a.encode(), np.uint8)
    y = np.frombuffer(b.encode(), np.uint8)
    n, m = len(x), len(y)
    if n == 0 or m == 0:
        return max(n, m)
    big = 1 << 40
    w = 2 * band + 1
    cols = np.arange(w)
    # row 0: D[0][j] = j, window starting at column 0
    prev = np.full(w, big, np.int64)
    prev[:min(w, m + 1)] = np.arange(min(w, m + 1))
    prev_lo = 0
    for i in range(1, n + 1):
        c = int(round(i * m / n))
        lo = max(0, c - band)
        hi = min(m, c + band)
        j = lo + cols
        valid = j <= hi

        def prev_at(jj):  # D[i-1][jj] from the previous row's window
            k = jj - prev_lo
            ok = (k >= 0) & (k < w)
            return np.where(ok, prev[np.clip(k, 0, w - 1)], big)

        diag = prev_at(j - 1) + (y[np.clip(j - 1, 0, m - 1)] != x[i - 1])
        diag = np.where(j >= 1, diag, big)
        up = prev_at(j) + 1
        t = np.minimum(diag, up)
        if lo == 0:
            t[0] = min(t[0], i)
        t = np.where(valid, t, big)
        cur = np.minimum.accumulate(t - j) + j
        cur = np.where(valid, cur, big)
        prev, prev_lo = cur, lo
    return int(prev[m - prev_lo])


def identity(seq: str, truth_seq: str, band: int = 256) -> float:
    return 1.0 - edit_distance(seq, truth_seq, band) / max(len(truth_seq), 1)


def read_fasta(path: str) -> dict:
    out, name, buf = {}, None, []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line.startswith(">"):
                if name is not None:
                    out[name] = "".join(buf)
                name, buf = line[1:].split()[0], []
            elif line:
                buf.append(line)
    if name is not None:
        out[name] = "".join(buf)
    return out


def load_truth(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)
