"""Native marginio engine vs the pure-Python I/O path."""

import struct

import numpy as np
import pytest

from margin_tpu.io import native
from margin_tpu.io.bam import BamReader, _iter_tags
from margin_tpu.params import Params
from margin_tpu.phase.chunker import (_construct_chunker_native,
                                      _construct_chunker_py)

from conftest import PARAMS


@pytest.fixture(autouse=True)
def _native_lib():
    if native.lib() is None:
        pytest.skip("native marginio library did not build")


@pytest.fixture(scope="module")
def BAM(sim_phase):
    return sim_phase["bam"]


def test_native_scan_matches_python_reader(BAM):
    nb = native.NativeBam(BAM)
    scan = nb.scan()
    nb.close()
    with BamReader(BAM) as r:
        py = list(r)
    assert len(scan["names"]) == len(py)
    for i in (0, len(py) // 2, len(py) - 1):
        assert scan["pos"][i] == py[i].pos
        assert scan["flag"][i] == py[i].flag
        assert scan["mapq"][i] == py[i].mapq


def test_native_fetch_matches_python_fetch(BAM):
    nb = native.NativeBam(BAM)
    n_native = sum(1 for _ in nb.fetch_raw(0, 30000, 40000))
    nb.close()
    with BamReader(BAM) as r:
        n_py = sum(1 for _ in r.fetch("sim1", 30000, 40000))
    assert n_native == n_py


def test_native_chunker_matches_python(BAM):
    params = Params.load(PARAMS)
    a = _construct_chunker_native(BAM, None, {"sim1"}, params.polish, True)
    b = _construct_chunker_py(BAM, None, {"sim1"}, params.polish, True)
    assert len(a.chunks) == len(b.chunks)
    for ca, cb in zip(a.chunks, b.chunks):
        assert (ca.ref_name, ca.chunk_overlap_start, ca.chunk_start,
                ca.chunk_end, ca.chunk_overlap_end) == \
               (cb.ref_name, cb.chunk_overlap_start, cb.chunk_start,
                cb.chunk_end, cb.chunk_overlap_end)
        assert ca.estimated_depth == cb.estimated_depth
    assert a.read_enumerator == b.read_enumerator


def test_native_haplotag_write_roundtrip(tmp_path, BAM):
    nb = native.NativeBam(BAM)
    names = nb.scan()["names"]
    nb.close()
    uniq = list(dict.fromkeys(names))
    tags = {uniq[0]: 1, uniq[1]: 2}
    out = str(tmp_path / "out.bam")
    h1, h2, h0 = native.write_haplotagged_native(BAM, out, tags)
    assert h1 >= 1 and h2 >= 1
    got = {}
    with BamReader(out) as r:
        total = 0
        for rec in r:
            total += 1
            blob = rec.tags_blob()
            for tag, typ, s, e in _iter_tags(blob):
                if tag == b"HP":
                    got.setdefault(rec.name, struct.unpack("<i", blob[s + 3:s + 7])[0])
    assert total == h1 + h2 + h0
    assert got[uniq[0]] == 1
    assert got[uniq[1]] == 2
