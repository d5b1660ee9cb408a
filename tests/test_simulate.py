"""Seeded inputs (margin_tpu/testing/simulate.py) and the checked-in
parameter file they come with."""

import filecmp
import json
import math
import os

import numpy as np
import pytest

from margin_tpu.io.bam import BamReader
from margin_tpu.io.vcf import parse_vcf
from margin_tpu.params import Params, StateMachineParams
from margin_tpu.testing import simulate

from conftest import PARAMS


def test_same_seed_same_bytes(tmp_path):
    for d in ("a", "b"):
        simulate.write_dataset(simulate.phase_dataset(11, span=30_000,
                                                      depth=8),
                               str(tmp_path / d))
    names = sorted(os.listdir(tmp_path / "a"))
    assert "reads.bam.bai" in names and "truth.json" in names
    _match, mismatch, errors = filecmp.cmpfiles(
        tmp_path / "a", tmp_path / "b", names, shallow=False)
    assert not mismatch and not errors
    other = simulate.phase_dataset(12, span=30_000, depth=8)
    assert other.reads[0].seq != simulate.phase_dataset(
        11, span=30_000, depth=8).reads[0].seq


def test_files_read_back_through_io(sim_phase):
    truth = json.load(open(sim_phase["truth"]))
    with BamReader(sim_phase["bam"]) as r:
        recs = list(r)
        n_fetch = sum(1 for _ in r.fetch("sim1", 50_000, 60_000))
    assert len(recs) == len(truth["read_hap"])
    assert [x.pos for x in recs] == sorted(x.pos for x in recs)
    assert 0 < n_fetch < len(recs)
    for rec in recs[:50]:
        assert rec.name in truth["read_hap"]
        # CIGAR query length == stored sequence length
        q = sum(int(n) for op, n in rec.cigar_ops() if op in (0, 1, 4))
        assert q == len(rec.seq())
    entries = parse_vcf(sim_phase["vcf"], None, use_rle=False)
    sites = [e for es in entries.values() for e in es]
    assert len(sites) == len(truth["het_sites"])
    assert all((e.gt1, e.gt2) == (0, 1) for e in sites)


def test_truth_is_consistent():
    """Haplotypes are the base plus exactly their edits; reads agree with
    the base at matched positions at the error model's identity, and
    better with their own haplotype at het SNVs than with the other."""
    ds = simulate.phase_dataset(5, span=60_000, depth=10, het_rate=3e-3)
    snvs = {p: (payload, h) for p, kind, payload, h in ds.het_sites
            if kind == "snv"}
    for h, hap in enumerate(ds.haps):
        mapped = hap.base_of >= 0
        bases = ds.base[hap.base_of[mapped]]
        diff = np.nonzero(hap.seq[mapped] != bases)[0]
        changed = set(hap.base_of[mapped][diff].tolist())
        assert changed == {p for p, (_, hh) in snvs.items() if hh == h}
    agree = [0, 0]
    eq = tot = 0
    for r in ds.reads:
        codes = np.searchsorted(simulate.BASES, np.frombuffer(r.seq,
                                                              np.uint8))
        rp, qp = r.pos, 0
        for op, ln in r.cigar:
            if op == simulate.OP_M:
                eq += int((ds.base[rp:rp + ln] == codes[qp:qp + ln]).sum())
                tot += ln
                for p in range(rp, rp + ln):
                    if p in snvs:
                        alt, hh = snvs[p]
                        if codes[qp + p - rp] == alt:
                            agree[int(hh == r.hap)] += 1
                rp, qp = rp + ln, qp + ln
            elif op in (simulate.OP_I, simulate.OP_S):
                qp += ln
            else:
                rp += ln
        assert qp == len(codes)
    assert 0.95 < eq / tot < 0.99          # ~3% substitutions + het sites
    assert agree[1] > 20 * max(agree[0], 1)  # alt alleles on their own hap


def test_params_file_loads_with_documented_geometry():
    p = Params.load(PARAMS)
    doc = json.load(open(PARAMS))
    assert doc["assumed"] and all(isinstance(a, str) for a in doc["assumed"])
    pp = p.polish
    assert (pp.chunkSize, pp.chunkBoundary, pp.maxDepth) == \
        (100_000, 10_000, 64)
    assert pp.useRunLengthEncoding and pp.repeat_sub_matrix is not None
    d = StateMachineParams.default_nucleotide()
    for f in ("t_match_continue", "t_gap_open_x", "t_gap_extend_y",
              "t_gap_switch_to_x"):
        assert math.isclose(getattr(pp.sm_forward, f), getattr(d, f),
                            rel_tol=1e-9)
    np.testing.assert_allclose(pp.sm_forward.match_probs, d.match_probs,
                               rtol=1e-9)
    rows = 10.0 ** pp.repeat_sub_matrix.log_probs[:, 1:, :]
    np.testing.assert_allclose(rows.sum(axis=2), 1.0, atol=1e-3)
    # long runs are read shorter more often than longer
    a = pp.repeat_sub_matrix.log_probs[0]
    assert a[8, 7] > a[8, 9]


@pytest.mark.parametrize("a,b,want", [
    ("ACGT", "ACGT", 0), ("ACGT", "AGT", 1), ("ACGTACGT", "TACGTACG", 2),
    ("", "ACG", 3), ("AAAACCCC", "AAACCCCC", 1)])
def test_edit_distance(a, b, want):
    from margin_tpu.testing.truth import edit_distance
    assert edit_distance(a, b) == want
