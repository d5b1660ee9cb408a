"""Synthetic banded-FB problems and the comparison rule for banded-FB
parity (device kernel vs the native C++ kernel, the scan path or the
float64 oracle).

A problem of depth D has D = lx + ly + 1 anti-diagonals. Its width is set
by the anchor spacing and the band expansion (`WIDTH_RECIPES`).

The comparison: posteriors of the pairs both sides keep agree within an
absolute bound; a pair kept by one side only must lie within that bound
of the threshold (it may flip across it); totals agree within a relative
bound. float32 log-space sums of magnitude |total| carry absolute errors
of about |total| * 2^-24 per step, which is why the bounds grow with D
(`bounds_for_depth`).
"""

from __future__ import annotations

import numpy as np

# band width bucket -> (anchor spacing, expansion): BandGeometry.build with
# these gives unsmoothed widths 13, 31, 53 and 91
WIDTH_RECIPES = {16: (10, 2), 32: (10, 20), 64: (50, 2), 128: (50, 40)}


def make_items(rng, n: int, depth: int, width: int, strands=(0, 1),
               error_rate: float = 0.1, rle: bool = False):
    """n problems of `depth` diagonals whose band falls in the `width`
    bucket: y is x with substitutions at `error_rate`, anchored on the
    main diagonal. Returns (items, expansion)."""
    step, expansion = WIDTH_RECIPES[width]
    lx = (depth - 1) // 2
    ly = depth - 1 - lx
    items = []
    for i in range(n):
        x = rng.integers(0, 4, lx).astype(np.int32)
        y = np.empty(ly, np.int32)
        m = min(lx, ly)
        y[:m] = x[:m]
        y[m:] = rng.integers(0, 4, ly - m)
        mut = rng.random(ly) < error_rate
        y[mut] = rng.integers(0, 4, int(mut.sum()))
        anchors = [(a, a, 4) for a in range(step, m - 1, step)]
        it = {"x_sym": x, "y_sym": y, "anchors": anchors,
              "strand": strands[i % len(strands)]}
        if rle:
            it["rep_x"] = rng.integers(1, 6, lx).astype(np.int32)
            it["rep_y"] = rng.integers(1, 6, ly).astype(np.int32)
        items.append(it)
    return items, expansion


def bounds_for_depth(depth: int):
    """(posterior absolute bound, total relative bound) for float32
    implementations of a problem of `depth` diagonals."""
    if depth <= 8192:
        return 2e-3, 1e-5
    if depth <= 65536:
        return 1e-2, 1e-5
    return 5e-2, 1e-5


# float32 kernels against the float64 oracle: the log-space forward and
# backward sums carry a relative rounding error of at most this (measured
# 1.5e-5 at ~2k diagonals on the H100), which a posterior inherits as an
# absolute error of about |total| times it
ORACLE_REL = 5e-5


def oracle_bounds(total: float):
    """(posterior absolute bound, total relative bound) of a float32 result
    against the float64 oracle whose total log probability is `total`."""
    return min(1.0, ORACLE_REL * abs(total)), ORACLE_REL


def compare(a, b, threshold: float, post_bound: float, total_bound: float):
    """Compare two ((matches, gapx, gapy), total) results. Returns a dict
    of the worst deviations; `ok` says whether they are within bounds."""
    (pa, ta), (pb, tb) = a, b
    worst = 0.0
    flips = 0
    bad_flips = 0
    for sa, sb in zip(pa, pb):
        da = {(int(x), int(y)): p / 1e7 for p, x, y in np.asarray(sa)}
        db = {(int(x), int(y)): p / 1e7 for p, x, y in np.asarray(sb)}
        for key in da.keys() & db.keys():
            worst = max(worst, abs(da[key] - db[key]))
        for key in da.keys() ^ db.keys():
            flips += 1
            p = da.get(key, db.get(key))
            if p >= threshold + post_bound:
                bad_flips += 1
    rel = abs(ta - tb) / max(abs(tb), 1.0)
    return {"max_abs_post": worst, "flips": flips, "bad_flips": bad_flips,
            "total_rel": rel,
            "ok": worst <= post_bound and bad_flips == 0
            and rel <= total_bound}
