"""Native C++ banded FB (native/marginfb.cc) vs the jax scan path.

Monster alignments route here on every backend; the kernel must
reproduce the scan path's posteriors (same f32 formulas, band, and
thresholding) for anchored/anchorless, ragged, RLE, and LUT variants."""

import numpy as np
import pytest

from margin_tpu.ops import banded, native_fb, pairhmm
from margin_tpu.params import Params, StateMachineParams

from conftest import PARAMS


@pytest.fixture(autouse=True)
def _native_lib():
    if native_fb.lib() is None:
        pytest.skip("native FB library did not build")


@pytest.fixture(scope="module")
def tables():
    return pairhmm.PairHmmTables.from_params(
        StateMachineParams.default_nucleotide())


@pytest.fixture(scope="module")
def tables_rle():
    params = Params.load(PARAMS)
    pp = params.polish
    return pairhmm.PairHmmTables.from_params(pp.sm_forward, pp.sm_reverse,
                                             repeat=pp.repeat_sub_matrix)


def _mk_item(rng, lx, ly, n_anchor, strand, rle=False, **kw):
    it = {"x_sym": rng.integers(0, 4, lx).astype(np.int32),
          "y_sym": rng.integers(0, 4, ly).astype(np.int32),
          "anchors": [], "strand": strand}
    if n_anchor:
        axs = np.sort(rng.choice(lx, n_anchor, replace=False))
        ays = np.sort(rng.choice(ly, n_anchor, replace=False))
        it["anchors"] = [(int(a), int(b), 4) for a, b in zip(axs, ays)]
    if rle:
        it["rep_x"] = rng.integers(1, 8, lx).astype(np.int32)
        it["rep_y"] = rng.integers(1, 8, ly).astype(np.int32)
    it.update(kw)
    return it


def _compare(tables, item, use_lut, expansion=6):
    (nm, ngx, ngy), nt = native_fb.posteriors_item(
        tables, item, expansion, 0.01, use_lut, False)
    (sm, sgx, sgy), st = banded.banded_posteriors(
        tables, item["x_sym"], item["y_sym"], item["anchors"], expansion,
        item["strand"], ragged_left=bool(item.get("ragged_left")),
        ragged_right=bool(item.get("ragged_right")), threshold=0.01,
        use_lut=use_lut, rep_x=item.get("rep_x"), rep_y=item.get("rep_y"))
    assert nt == pytest.approx(st, abs=2e-3)
    for a, b in zip((nm, ngx, ngy), (sm, sgx, sgy)):
        # posteriors near the 1% threshold may flip between float
        # implementations; compare on the common pair set
        ka = {(int(x), int(y)): int(p) for p, x, y in a}
        kb = {(int(x), int(y)): int(p) for p, x, y in b}
        common = set(ka) & set(kb)
        assert len(common) >= 0.98 * max(len(ka), len(kb), 1)
        for key in common:
            assert abs(ka[key] - kb[key]) <= 2000, key  # 2e-4 in prob


@pytest.mark.parametrize("use_lut", [False, True])
def test_native_matches_scan(tables, use_lut):
    rng = np.random.default_rng(5)
    for item in (_mk_item(rng, 60, 64, 7, 0),
                 _mk_item(rng, 50, 50, 0, 1),          # anchorless
                 _mk_item(rng, 45, 52, 5, 0, ragged_left=True),
                 _mk_item(rng, 45, 52, 5, 1, ragged_right=True)):
        _compare(tables, item, use_lut)


@pytest.mark.parametrize("use_lut", [False, True])
def test_native_matches_scan_rle(tables_rle, use_lut):
    rng = np.random.default_rng(9)
    for item in (_mk_item(rng, 70, 64, 8, 0, rle=True),
                 _mk_item(rng, 40, 44, 0, 1, rle=True)):
        _compare(tables_rle, item, use_lut)


@pytest.mark.slow  # ~70s: a genuinely monster-sized band
def test_monster_routing(tables):
    """banded_posteriors_many must produce the native result for items
    above the monster-cell policy (consistent on every backend)."""
    rng = np.random.default_rng(3)
    # anchorless 8000x8000: 64M band cells > _MONSTER_CELLS
    item = _mk_item(rng, 8000, 8000, 0, 0)
    (res,) = banded.banded_posteriors_many(tables, [item], expansion=6,
                                           threshold=0.01)
    want = native_fb.posteriors_item(tables, item, 6, 0.01, False, False)
    assert res[1] == want[1]
    for a, b in zip(res[0], want[0]):
        np.testing.assert_array_equal(a, b)


def test_native_cap_overflow_retry(tables):
    """A low threshold floods the output buffer: the binding must grow the
    cap and return the complete pair set."""
    rng = np.random.default_rng(17)
    item = _mk_item(rng, 300, 300, 0, 0)  # anchorless: dense posteriors
    (m, gx, gy), t = native_fb.posteriors_item(tables, item, 6, 1e-6,
                                               True, False)
    n = len(m) + len(gx) + len(gy)
    assert n > 4 * 600 + 1024  # forced at least one retry
    # coordinates within bounds (gap states may sit at -1, i.e. before the
    # first base, like the jax extraction) and sorted per state
    for arr in (m, gx, gy):
        if len(arr):
            assert arr[:, 1].min() >= -1 and arr[:, 1].max() < 300
            assert (np.diff(arr[:, 1]) >= 0).all()
    assert m[:, 1].min() >= 0  # matches always consume a base


def test_cpu_midsize_default_native_matches_scan(tables):
    """ADVICE r2: the CPU backend routes >50K-cell mid-size bands to the
    native kernel BY DEFAULT (banded_posteriors_many), while the per-item
    banded_posteriors always takes the scan path — the two must agree
    exactly on such an item (pair sets, probs, and bit-equal totals)."""
    import os
    assert "MARGIN_TPU_NATIVE_SCAN_CELLS" not in os.environ
    rng = np.random.default_rng(5)
    lx = ly = 800
    x = rng.integers(0, 4, lx).astype(np.uint8)
    y = x.copy()
    mut = rng.random(ly) < 0.12
    y[mut] = rng.integers(0, 4, mut.sum()).astype(np.uint8)
    anchors = [(i, i) for i in range(0, lx, 50)]
    geom = banded.BandGeometry.build(anchors, lx, ly, 20)
    assert banded._true_band_cells(geom) > banded._NATIVE_SCAN_CELLS_CPU
    # the default-thresholded many path must route this item native on CPU
    import jax
    assert jax.default_backend() == "cpu"
    (m1, g1x, g1y), t1 = banded.banded_posteriors(tables, x, y, anchors,
                                                  20, 0)
    [((m2, g2x, g2y), t2)] = banded.banded_posteriors_many(
        tables, [dict(x_sym=x, y_sym=y, anchors=anchors, strand=0)], 20)
    assert t1 == t2
    for a, b in ((m1, m2), (g1x, g2x), (g1y, g2y)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_ipc_worker_local_fallback_split(tables, monkeypatch):
    """Worker-process routing: bands wider than the device kernel's 128
    lanes solve on the worker's OWN native kernel, everything else crosses
    the IPC socket to the parent's funnel. Results land in request
    order either way."""
    from margin_tpu.parallel import executor

    rng = np.random.default_rng(11)
    lx = ly = 2000
    x = rng.integers(0, 4, lx).astype(np.uint8)
    y = x.copy()
    mut = rng.random(ly) < 0.1
    y[mut] = rng.integers(0, 4, mut.sum()).astype(np.uint8)
    # anchors every 400 bp: a band far wider than 128
    wide = dict(x_sym=x, y_sym=y, anchors=[(i, i, 4) for i in
                                           range(0, lx, 400)], strand=0)
    narrow = dict(x_sym=x[:300], y_sym=y[:300],
                  anchors=[(i, i, 4) for i in range(10, 290, 10)], strand=1)
    assert banded._item_geom(dict(wide), 20, False).w_pad > 128
    assert banded._item_geom(dict(narrow), 20, False).w_pad <= 128

    seen = []

    class StubClient:
        def banded(self, tables_, items, expansion, threshold, use_lut,
                   dynamic):
            seen.append(len(items))
            return banded._posteriors_many_scan(
                tables_, items, expansion, threshold=threshold,
                use_lut=use_lut, dynamic=dynamic)

        def score(self, *a):  # pragma: no cover
            raise AssertionError

    monkeypatch.setattr(executor, "_IPC_CLIENT", StubClient())
    try:
        results = banded.banded_posteriors_many(
            tables, [dict(wide), dict(narrow)], 20)
        assert seen == [1]  # only the narrow item crossed the "socket"
        seen.clear()
        banded.banded_posteriors_many(tables, [dict(narrow)], 20)
        assert seen == [1]
    finally:
        monkeypatch.setattr(executor, "_IPC_CLIENT", None)
    [direct_wide] = banded._solve_native_items(tables, [wide], 20, 0.01,
                                               False, False)
    assert results[0][1] == direct_wide[1]
    for a, b in zip(results[0][0], direct_wide[0]):
        np.testing.assert_array_equal(a, b)
    [direct_narrow] = banded._posteriors_many_scan(tables, [narrow], 20)
    assert results[1][1] == direct_narrow[1]
    np.testing.assert_array_equal(results[1][0][0], direct_narrow[0][0])
