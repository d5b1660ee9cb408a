"""Triton banded forward-backward (ops/banded_triton.py): the kernels in
interpret mode against the lax.scan path and the float64 oracle, and the
wrapper's packing, padding and routing. The compiled kernel runs on the
GPU only (`gpu` marker; chip_smoke.py runs the same comparison there)."""

import numpy as np
import pytest

from margin_tpu.ops import banded, banded_triton as bt, pairhmm
from margin_tpu.params import Params, StateMachineParams
from margin_tpu.testing import fb_parity, oracle

from conftest import PARAMS


@pytest.fixture(scope="module")
def tables():
    return pairhmm.PairHmmTables.from_params(
        StateMachineParams.default_nucleotide())


@pytest.fixture(scope="module")
def tables_rle():
    pp = Params.load(PARAMS).polish
    return pairhmm.PairHmmTables.from_params(pp.sm_forward, pp.sm_reverse,
                                             repeat=pp.repeat_sub_matrix)


def _items(rng, width, n, depth=161, rle=False):
    items, exp = fb_parity.make_items(rng, n, depth, width, rle=rle)
    items[0]["ragged_left"] = True
    if n > 1:
        items[-1]["ragged_right"] = True
    return items, exp


def _device(tables, items, exp, use_lut):
    res, n_native = banded.posteriors_many_device(
        tables, items, exp, 0.01, use_lut, False, interpret=True)
    assert n_native == 0
    return res


@pytest.mark.parametrize("width,use_lut,rle", [
    (16, True, False), (16, False, True), (32, True, True),
    (64, False, False), (128, True, False)])
def test_kernel_matches_scan(tables, tables_rle, width, use_lut, rle):
    """Same recurrence, same operation order: the interpreted kernel and
    the scan give the same pairs and totals."""
    rng = np.random.default_rng(width)
    t = tables_rle if rle else tables
    items, exp = _items(rng, width, 3, rle=rle)
    got = _device(t, items, exp, use_lut)
    want = banded._posteriors_many_scan(t, items, exp, 0.01, use_lut,
                                        False, smooth=True)
    for g, w in zip(got, want):
        c = fb_parity.compare(g, w, 0.01, 1e-6, 1e-6)
        assert c["ok"] and c["flips"] == 0, c


def test_kernel_matches_oracle(tables):
    rng = np.random.default_rng(2)
    items, exp = fb_parity.make_items(rng, 1, 121, 16)
    it = items[0]
    [got] = _device(tables, items, exp, True)
    m, gx, gy, tot = oracle.oracle_posteriors(
        oracle.OracleStateMachine(StateMachineParams.default_nucleotide()),
        it["x_sym"], it["y_sym"], it["anchors"], exp)
    want = (tuple(np.array([(int(p * 1e7), x, y) for p, x, y in v],
                           np.int64).reshape(-1, 3) for v in (m, gx, gy)),
            tot)
    c = fb_parity.compare(got, want, 0.01, 2e-3, 1e-5)
    assert c["ok"], c


def test_group_size_and_warps():
    assert [bt.group_size(w) for w in bt.WIDTHS] == [2, 1, 1, 1]
    assert [bt.num_warps(w) for w in bt.WIDTHS] == [1, 1, 2, 4]
    assert bt.bucket_w(13) == 16 and bt.bucket_w(33) == 64
    with pytest.raises(ValueError):
        bt.bucket_w(129)


def test_pack_layout_is_ragged(tables):
    """Programs own contiguous diagonal runs sized by their own depth:
    no problem is padded to the deepest one, and the program count is a
    power of two (pad programs are empty)."""
    rng = np.random.default_rng(4)
    items = []
    for depth in (401, 301, 201, 101, 61):
        its, exp = fb_parity.make_items(rng, 1, depth, 16)
        items += its
    geoms = [banded._item_geom(it, exp, False) for it in items]
    pack = bt.build_pack(tables, items, geoms, 16, False)
    G = bt.group_size(16)
    n_prog = len(pack.prog) // 2
    assert n_prog == 4 and pack.b_pad == 8            # ceil(5/2) -> 4
    offs, dmax = pack.prog[0::2], pack.prog[1::2]
    assert list(dmax[:3]) == [400, 200, 60]           # max of each pair
    assert list(np.diff(offs[:3])) == [403, 203]      # dmax + tail rows
    assert pack.used == (403 + 203 + 63) * 3 * 16 * G
    assert pack.n_rows >= offs[2] + 63 and pack.n_rows % 1024 == 0
    assert bt.pack_cells(geoms, 16) == pack.used


def test_next_pack_splits_at_the_budget(tables):
    rng = np.random.default_rng(5)
    items, exp = fb_parity.make_items(rng, 6, 301, 32)
    run = banded._DeviceRun(tables, exp, 0.01, True, False, interpret=True)
    run.budget = bt.pack_cells([banded._item_geom(it, exp, False)
                                for it in items[:2]], 32)
    refs = [banded._FbItemRef(it, [None] * 6, i) for i, it in
            enumerate(items)]
    run.add(refs)
    sizes = []
    while run.buckets:
        _key, pack = run._next_pack()
        sizes.append(len(pack))
    assert sizes == [2, 2, 2]


def test_wide_bands_route_to_native(tables):
    """Bands wider than 128 solve on the native kernel, with the same
    results as calling it directly; the rest still ride the kernel."""
    from margin_tpu.ops import native_fb
    if native_fb.lib() is None:
        pytest.skip("native FB library did not build")
    rng = np.random.default_rng(6)
    narrow, exp = fb_parity.make_items(rng, 1, 201, 16)
    x = rng.integers(0, 4, 600).astype(np.int32)
    wide = {"x_sym": x, "y_sym": x.copy(), "anchors": [(300, 300, 4)],
            "strand": 0}
    assert banded._item_geom(dict(wide), exp, False).w_pad > 128
    res, n_native = banded.posteriors_many_device(
        tables, [wide] + narrow, exp, 0.01, True, False, interpret=True)
    assert n_native == 1
    [want] = banded._solve_native_items(tables, [wide], exp, 0.01, True,
                                        False)
    assert res[0][1] == want[1]
    for a, b in zip(res[0][0], want[0]):
        np.testing.assert_array_equal(a, b)


def test_extraction_overflow_relaunches(tables, monkeypatch):
    """A too-small extraction capacity is detected from the count and the
    pack re-launched with the exact capacity."""
    rng = np.random.default_rng(7)
    items, exp = fb_parity.make_items(rng, 2, 301, 16)
    want, _ = banded.posteriors_many_device(tables, items, exp, 0.01, True,
                                            False, interpret=True)
    ks = []
    real = bt.k_for

    def first_tiny(n):
        ks.append(8 if not ks else real(n))
        return ks[-1]

    monkeypatch.setattr(bt, "k_for", first_tiny)
    got, _ = banded.posteriors_many_device(tables, items, exp, 0.01, True,
                                           False, interpret=True)
    assert len(ks) == 2 and ks[0] == 8 and ks[1] >= 16384
    for (gp, gt), (wp, wt) in zip(got, want):
        assert gt == wt
        for a, b in zip(gp, wp):
            np.testing.assert_array_equal(a, b)


def test_pack_budget_default_on_cpu():
    assert banded.pack_cell_budget() == banded._PACK_CELLS_DEFAULT


@pytest.mark.gpu
def test_compiled_kernel_matches_native(tables):
    """The Triton-compiled kernel on the card against the native kernel."""
    import jax
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (run by chip_smoke.py on the card)")
    rng = np.random.default_rng(8)
    items, exp = fb_parity.make_items(rng, 8, 6144, 16)
    got, n_native = banded.posteriors_many_device(tables, items, exp, 0.01,
                                                  True, False)
    want = banded._solve_native_items(tables, items, exp, 0.01, True, False)
    for a, b in zip(got, want):
        assert fb_parity.compare(a, b, 0.01, 2e-3, 1e-5)["ok"]
