"""BCF 2.2 reader (io/bcf.py): binary variant input for the phase
pipeline, parity with htslib's transparent bcf_open (vcf.c)."""

import numpy as np
import pytest

from margin_tpu.io import bcf
from margin_tpu.io.vcf import parse_vcf


@pytest.fixture(scope="module")
def vcf(sim_phase):
    return sim_phase["vcf"]


@pytest.fixture(scope="module")
def bcf_path(tmp_path_factory, vcf):
    p = str(tmp_path_factory.mktemp("bcf") / "vars.bcf")
    with open(vcf) as fh:
        bcf.vcf_to_bcf([ln.rstrip("\n") for ln in fh], p)
    assert bcf.is_bcf(p)
    return p


def test_bcf_lines_roundtrip_core_fields(bcf_path, vcf):
    with open(vcf) as fh:
        want = [ln.rstrip("\n") for ln in fh if not ln.startswith("#")]
    got = [ln for ln in bcf.BcfReader(bcf_path).lines()
           if not ln.startswith("#")]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        gc, wc = g.split("\t"), w.split("\t")
        # CHROM POS ID REF ALT + GT (writer carries the core set)
        assert gc[0] == wc[0] and gc[1] == wc[1]
        assert gc[3] == wc[3] and gc[4] == wc[4]
        g_gt = gc[9].split(":")[0] if len(gc) > 9 else None
        w_gt = wc[9].split(":")[0] if len(wc) > 9 else None
        assert g_gt == w_gt, (g, w)


def test_bcf_through_vcf_loader(bcf_path, vcf):
    """parse_vcf must consume BCF transparently (bcf_open parity)."""
    entries_v = parse_vcf(vcf, None, use_rle=False)
    entries_b = parse_vcf(bcf_path, None, use_rle=False)
    for contig in entries_v:
        ev, eb = entries_v[contig], entries_b[contig]
        assert len(ev) == len(eb)
        for a, b in zip(ev, eb):
            assert a.ref_pos == b.ref_pos
            assert list(a.alleles) == list(b.alleles)
            assert a.gt1 == b.gt1 and a.gt2 == b.gt2
