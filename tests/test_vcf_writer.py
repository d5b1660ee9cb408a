"""Phased-VCF writer unit tests: the updateAllOutputVCFFormatFields=true
FORMAT-field path (vcf.c:725-731, 957-1008) and multi-sample handling."""

import pytest

from margin_tpu.io.vcf import VcfEntry
from margin_tpu.io.vcf_writer import _to_phred, write_phased_vcf
from margin_tpu.params import Params
from margin_tpu.rle import RleString

from conftest import PARAMS

HEADER = """##fileformat=VCFv4.2
##contig=<ID=chr1>
##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">
#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t{samples}
"""


def _entry(pos, alleles, gt1, gt2, pgt1, pgt2, reads_by_allele,
           gq=0.99, h1=0.98, h2=0.97):
    e = VcfEntry("chr1", pos, pos, 30.0, False, False,
                 [RleString.identity(a) for a in alleles], gt1, gt2)
    e.was_updated = True
    e.phased_gt1, e.phased_gt2 = pgt1, pgt2
    e.genotype_prob = gq
    e.haplotype1_prob, e.haplotype2_prob = h1, h2
    e.init_read_sets()
    for i, reads in enumerate(reads_by_allele):
        e.allele_idx_to_read_ids[i] = set(reads)
    return e


def _write_input(tmp_path, body, samples="S1"):
    p = tmp_path / "in.vcf"
    p.write_text(HEADER.format(samples=samples) + body)
    return str(p)


@pytest.fixture(scope="module")
def params():
    return Params.load(PARAMS)


def test_to_phred_clamps():
    # misc.c:139-141
    assert _to_phred(0.05) == 60
    assert _to_phred(1.0) == 0
    assert _to_phred(0.9) == 0  # -10*log10(0.9) = 0.46 -> int 0


def test_update_all_format_fields(tmp_path, params):
    params.phase.updateAllOutputVCFFormatFields = True
    vcf_in = _write_input(
        tmp_path,
        "chr1\t101\t.\tA\tC\t30\tPASS\t.\tGT\t0/1\n"
        "chr1\t201\t.\tG\tT\t30\tPASS\t.\tGT\t0/1\n")
    e1 = _entry(100, ["A", "C"], 0, 1, 0, 1,
                [{"r1", "r2", "r3"}, {"r4", "r5"}])
    e2 = _entry(200, ["G", "T"], 0, 1, 1, 0,
                [{"r1", "r2"}, {"r4", "r5", "r6"}])
    out = str(tmp_path / "out.vcf")
    bed = str(tmp_path / "out.bed")
    write_phased_vcf(vcf_in, None, out, bed, {"chr1": [e1, e2]}, params)

    lines = open(out).read().splitlines()
    fmt_ids = [ln.split("ID=")[1].split(",")[0]
               for ln in lines if ln.startswith("##FORMAT")]
    for fid in ("GT", "PS", "GQ", "DP", "HQ", "HD", "HCPV", "HDPV"):
        assert fid in fmt_ids, fmt_ids
    recs = [ln.split("\t") for ln in lines if not ln.startswith("#")]
    assert len(recs) == 2
    # first record: new phase set at POS 101 (0-based 100)
    fmt = recs[0][8].split(":")
    smp = dict(zip(fmt, recs[0][9].split(":")))
    assert smp["GT"] == "0|1"
    assert smp["PS"] == "100"
    assert smp["GQ"] == str(_to_phred(0.99))
    assert smp["DP"] == "5"
    assert smp["HD"] == "3,2"
    assert smp["HQ"] == f"{_to_phred(0.98)},{_to_phred(0.97)}"
    # second record: phased 1|0; hap1 set={r4,r5,r6} vs prev hap1={r1..3}
    fmt2 = recs[1][8].split(":")
    smp2 = dict(zip(fmt2, recs[1][9].split(":")))
    assert smp2["GT"] == "1|0"
    assert smp2["HD"] == "3,2"
    # concordance: prevH1={r1,r2,r3} currH1={r4,r5,r6} -> 0; prevH2={r4,r5}
    # currH2={r1,r2} -> 0; discordant: prevH2&currH1={r4,r5}=2,
    # prevH1&currH2={r1,r2}=2
    assert smp2["HCPV"] == "0,0"
    assert smp2["HDPV"] == "2,2"
    params.phase.updateAllOutputVCFFormatFields = False


def test_update_all_homozygous_called(tmp_path, params):
    """Margin-called hom: GT unphased, no PS, but fields still written."""
    params.phase.updateAllOutputVCFFormatFields = True
    vcf_in = _write_input(
        tmp_path, "chr1\t101\t.\tA\tC\t30\tPASS\t.\tGT\t0/1\n")
    e1 = _entry(100, ["A", "C"], 0, 1, 1, 1, [set(), {"r4", "r5"}])
    out = str(tmp_path / "out2.vcf")
    write_phased_vcf(vcf_in, None, out, None, {"chr1": [e1]}, params)
    rec = [ln for ln in open(out) if not ln.startswith("#")][0].split("\t")
    smp = dict(zip(rec[8].split(":"), rec[9].strip().split(":")))
    assert smp["GT"] == "1/1"
    assert "PS" not in smp
    assert smp["DP"] == "2"
    assert "HCPV" not in smp
    params.phase.updateAllOutputVCFFormatFields = False


def test_multi_sample_second_sample_untouched(tmp_path, params):
    vcf_in = _write_input(
        tmp_path,
        "chr1\t101\t.\tA\tC\t30\tPASS\t.\tGT:AD\t0/1:3,2\t1/1:0,9\n",
        samples="S1\tS2")
    e1 = _entry(100, ["A", "C"], 0, 1, 0, 1, [{"r1"}, {"r2"}])
    out = str(tmp_path / "out3.vcf")
    write_phased_vcf(vcf_in, None, out, None, {"chr1": [e1]}, params)
    rec = [ln for ln in open(out) if not ln.startswith("#")][0]
    parts = rec.rstrip("\n").split("\t")
    fmt = parts[8].split(":")
    s1 = dict(zip(fmt, parts[9].split(":")))
    s2 = dict(zip(fmt, parts[10].split(":")))
    assert s1["GT"] == "0|1"
    assert s1["PS"] == "100"
    # second sample keeps its original fields, "." for new keys
    assert s2["GT"] == "1/1"
    assert s2["AD"] == "0,9"
    assert s2["PS"] == "."
