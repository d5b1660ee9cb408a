"""Pair-HMM kernel vs the numpy oracle (which mirrors the reference C
algorithm cell-for-cell, incl. the logAdd LUT)."""

import numpy as np
import pytest

import jax.numpy as jnp

from margin_tpu.alphabet import seq_to_symbols
from margin_tpu.ops import pairhmm
from margin_tpu.params import Params, StateMachineParams
from margin_tpu.testing import oracle

from conftest import PARAMS


def _random_pair(rng, lmin=5, lmax=40, mutate=0.12):
    lx = int(rng.integers(lmin, lmax))
    x = rng.integers(0, 4, lx)
    # y = mutated copy of x (ONT-like)
    y = []
    for s in x:
        r = rng.random()
        if r < mutate / 3:
            continue  # deletion
        if r < 2 * mutate / 3:
            y.append(int(rng.integers(0, 4)))  # substitution
        else:
            y.append(int(s))
        if rng.random() < mutate / 3:
            y.append(int(rng.integers(0, 4)))  # insertion
    if not y:
        y = [0]
    return x.astype(np.uint8), np.array(y, dtype=np.uint8)


@pytest.fixture(scope="module")
def base_params():
    return Params.load(PARAMS)


def test_forward_total_matches_oracle_default_sm(base_params):
    rng = np.random.default_rng(42)
    smp = StateMachineParams.default_nucleotide()
    osm = oracle.OracleStateMachine(smp)
    pairs = [_random_pair(rng) for _ in range(24)]
    ragged_l = rng.random(24) < 0.5
    ragged_r = rng.random(24) < 0.5
    expected = np.array([
        oracle.oracle_forward_probability(osm, x, y, ragged_left=bool(rl),
                                          ragged_right=bool(rr))
        for (x, y), rl, rr in zip(pairs, ragged_l, ragged_r)])

    tables = pairhmm.PairHmmTables.from_params(smp, dtype=jnp.float64)
    batch = pairhmm.make_batch(pairs, ragged_left=ragged_l, ragged_right=ragged_r)
    got = np.asarray(pairhmm.forward_total(tables, batch, use_lut=True))[:len(pairs)]
    np.testing.assert_allclose(got, expected, rtol=0, atol=1e-9)


def test_forward_total_trained_sm_both_strands(base_params):
    rng = np.random.default_rng(7)
    sm_f = base_params.polish.sm_forward
    sm_r = base_params.polish.sm_reverse
    pairs = [_random_pair(rng) for _ in range(16)]
    strands = (rng.random(16) < 0.5).astype(np.int32)
    expected = np.array([
        oracle.oracle_forward_probability(
            oracle.OracleStateMachine(sm_f if s == 0 else sm_r), x, y)
        for (x, y), s in zip(pairs, strands)])
    tables = pairhmm.PairHmmTables.from_params(sm_f, sm_r, dtype=jnp.float64)
    batch = pairhmm.make_batch(pairs, strands=strands)
    got = np.asarray(pairhmm.forward_total(tables, batch, use_lut=True))[:len(pairs)]
    np.testing.assert_allclose(got, expected, rtol=0, atol=1e-9)


def test_forward_total_exact_close_to_lut(base_params):
    # The production path uses exact logaddexp; it must agree with the LUT
    # semantics to ~1e-2 absolute in log space on realistic sizes.
    rng = np.random.default_rng(3)
    smp = base_params.polish.sm_forward
    pairs = [_random_pair(rng, 20, 35) for _ in range(8)]
    tables = pairhmm.PairHmmTables.from_params(smp, dtype=jnp.float64)
    batch = pairhmm.make_batch(pairs)
    lut = np.asarray(pairhmm.forward_total(tables, batch, use_lut=True))[:len(pairs)]
    exact = np.asarray(pairhmm.forward_total(tables, batch, use_lut=False))[:len(pairs)]
    np.testing.assert_allclose(exact, lut, rtol=0, atol=5e-2)


def test_forward_total_with_ns():
    smp = StateMachineParams.default_nucleotide()
    osm = oracle.OracleStateMachine(smp)
    x = seq_to_symbols("ACGNNTACGT")
    y = seq_to_symbols("ACGTNCGT")
    expected = oracle.oracle_forward_probability(osm, x, y)
    tables = pairhmm.PairHmmTables.from_params(smp, dtype=jnp.float64)
    batch = pairhmm.make_batch([(x, y)])
    got = float(pairhmm.forward_total(tables, batch, use_lut=True)[0])
    assert abs(got - expected) < 1e-9


def test_forward_total_rle_emissions():
    """RLE mode: match emissions get the repeat-count addend
    (stateMachine.c:733-738)."""
    p = Params.load(PARAMS)
    rng = np.random.default_rng(11)
    sm_f, sm_r = p.polish.sm_forward, p.polish.sm_reverse
    rm = p.polish.repeat_sub_matrix
    pairs, reps, strands = [], [], []
    for i in range(8):
        x, y = _random_pair(rng, 8, 20)
        rx = rng.integers(1, 8, len(x))
        ry = rng.integers(1, 8, len(y))
        pairs.append((x, y))
        reps.append((rx, ry))
        strands.append(i % 2)

    def enc(sym, rep):
        return (np.asarray(rep, dtype=np.int64) << 8) | np.asarray(sym, np.int64)

    expected = []
    for (x, y), (rx, ry), s in zip(pairs, reps, strands):
        osm = oracle.OracleStateMachine(sm_f if s == 0 else sm_r,
                                        repeat_matrix=rm, forward_strand=(s == 0))
        expected.append(oracle.oracle_forward_probability(osm, enc(x, rx), enc(y, ry)))
    tables = pairhmm.PairHmmTables.from_params(sm_f, sm_r, repeat=rm,
                                               dtype=jnp.float64)
    batch = pairhmm.make_batch(pairs, strands=np.array(strands),
                               rep_pairs=reps)
    got = np.asarray(pairhmm.forward_total(tables, batch, use_lut=True))[:len(pairs)]
    np.testing.assert_allclose(got, np.array(expected), rtol=0, atol=1e-9)


def test_trivial_empty_pair():
    smp = StateMachineParams.default_nucleotide()
    tables = pairhmm.PairHmmTables.from_params(smp, dtype=jnp.float64)
    batch = pairhmm.make_batch([(np.zeros(0, np.uint8), np.zeros(0, np.uint8)),
                                (np.array([1], np.uint8), np.array([1], np.uint8))])
    got = np.asarray(pairhmm.forward_total(tables, batch, use_lut=True))
    assert got[0] == 0.0  # LOG_ONE (pairwiseAligner.c:860-862)
    osm = oracle.OracleStateMachine(smp)
    exp1 = oracle.oracle_forward_probability(osm, np.array([1]), np.array([1]))
    assert abs(got[1] - exp1) < 1e-9
