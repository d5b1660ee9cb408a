"""Native stRPHmm engine (native/marginrp.cc) vs the Python oracle.

The engine mirrors margin_tpu/phase/rphmm.py operation-for-operation, so
under maxNotSumTransitions every float64 in the fused HMM must match the
oracle bitwise — partitions, merge structure, FB arrays, traceback."""

import numpy as np
import pytest

from margin_tpu.params import Params
from margin_tpu.phase import native_rp, rphmm
from margin_tpu.phase.bubbles import ProfileSeq, Reference, Site
from tests.conftest import PARAMS


@pytest.fixture(scope="module")
def phase_params():
    return Params.load(PARAMS).phase


def _make_case(rng, n_sites, n_reads, max_alleles=3):
    sites = []
    off = 0
    for _ in range(n_sites):
        a = int(rng.integers(2, max_alleles + 1))
        prior = rng.integers(0, 60, a).astype(np.uint16)
        sub = rng.integers(0, 90, (a, a)).astype(np.uint16)
        np.fill_diagonal(sub, 0)
        sites.append(Site(a, off, prior, sub))
        off += a
    ref = Reference("r", sites, off)
    offsets = ref.allele_offsets()
    seqs = []
    for i in range(n_reads):
        s = int(rng.integers(0, n_sites))
        ln = int(rng.integers(1, n_sites - s + 1))
        a0, a1 = int(offsets[s]), int(offsets[s + ln])
        probs = rng.integers(0, 60, a1 - a0).astype(np.uint8)
        seqs.append(ProfileSeq(object(), f"read{i:03d}", s, ln, a0, probs))
    return ref, seqs


def _run_oracle(fwd, rev, ref, pp):
    tp_f = rphmm.get_rp_hmms(fwd, ref, pp)
    tp_r = rphmm.get_rp_hmms(rev, ref, pp)
    merged = rphmm.merge_two_tiling_paths(tp_f, tp_r, include_ancestor=False)
    hmm = rphmm.fuse_tiling_path(merged)
    hmm.forward_backward(include_ancestor=True)
    return hmm


def _assert_hmm_equal(h_py, h_c):
    assert h_c.ref_start == h_py.ref_start
    assert h_c.ref_length == h_py.ref_length
    assert len(h_c.columns) == len(h_py.columns)
    for cp, cc in zip(h_py.columns, h_c.columns):
        assert cc.partitions == cp.partitions
        assert [id(s) for s in cc.seqs] == [id(s) for s in cp.seqs]
        np.testing.assert_array_equal(cc.forward, cp.forward)
        np.testing.assert_array_equal(cc.backward, cp.backward)
        np.testing.assert_array_equal(cc.emission, cp.emission)
        assert cc.total_log_prob == cp.total_log_prob
    for mp, mc in zip(h_py.merges, h_c.merges):
        assert mc.mask_from == mp.mask_from
        assert mc.mask_to == mp.mask_to
        assert mc.from_parts == mp.from_parts
        assert mc.to_parts == mp.to_parts
    assert h_c.forward_traceback() == h_py.forward_traceback()


def test_native_rp_matches_oracle_randomized(phase_params):
    if native_rp.lib() is None:
        pytest.skip("native rp engine unavailable")
    rng = np.random.default_rng(42)
    for _ in range(12):
        n_sites = int(rng.integers(2, 12))
        n_reads = int(rng.integers(1, 14))
        ref, seqs = _make_case(rng, n_sites, n_reads)
        k = int(rng.integers(0, n_reads + 1))
        fwd, rev = seqs[:k], seqs[k:]
        h_py = _run_oracle(fwd, rev, ref, phase_params)
        h_c = native_rp.phase_fused_hmm(fwd, rev, ref, phase_params)
        assert h_c is not None
        _assert_hmm_equal(h_py, h_c)


def test_native_rp_deep_case(phase_params):
    """Depth near the 64-read ceiling with many overlapping reads: the
    prune keep-counts and inverted-partition dedup all engage."""
    if native_rp.lib() is None:
        pytest.skip("native rp engine unavailable")
    rng = np.random.default_rng(7)
    ref, seqs = _make_case(rng, 6, 40, max_alleles=2)
    fwd, rev = seqs[::2], seqs[1::2]
    h_py = _run_oracle(fwd, rev, ref, phase_params)
    h_c = native_rp.phase_fused_hmm(fwd, rev, ref, phase_params)
    assert h_c is not None
    _assert_hmm_equal(h_py, h_c)


def test_native_rp_depth64_stress(phase_params):
    """Randomized stress at the reference's hard depth ceiling of 64 reads
    per column (margin.h:142, hmm.c:534-750): full-width uint64 partition
    masks, maximal merge fan-in, and the threaded merge recursion all
    engage; outputs must stay bitwise equal to the oracle."""
    if native_rp.lib() is None:
        pytest.skip("native rp engine unavailable")
    rng = np.random.default_rng(64)
    for trial in range(3):
        ref, seqs = _make_case(rng, 5, 64, max_alleles=2)
        # force every read to span all sites -> one 64-deep column run
        offsets = ref.allele_offsets()
        deep = []
        for i, s in enumerate(seqs):
            a0, a1 = int(offsets[0]), int(offsets[-1])
            probs = rng.integers(0, 60, a1 - a0).astype(np.uint8)
            deep.append(ProfileSeq(object(), f"deep{i:03d}", 0,
                                   len(ref.sites), a0, probs))
        fwd, rev = deep[:32], deep[32:]
        h_py = _run_oracle(fwd, rev, ref, phase_params)
        h_c = native_rp.phase_fused_hmm(fwd, rev, ref, phase_params)
        assert h_c is not None
        assert max(c.depth for c in h_c.columns) == 64
        _assert_hmm_equal(h_py, h_c)


def test_native_rp_single_strand(phase_params):
    if native_rp.lib() is None:
        pytest.skip("native rp engine unavailable")
    rng = np.random.default_rng(3)
    ref, seqs = _make_case(rng, 4, 5)
    h_py = _run_oracle(seqs, [], ref, phase_params)
    h_c = native_rp.phase_fused_hmm(seqs, [], ref, phase_params)
    assert h_c is not None
    _assert_hmm_equal(h_py, h_c)
