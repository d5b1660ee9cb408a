"""stitchingTest.c parity: overlapping chunks stitch back to the original
sequence."""

import json
import random

import pytest

from margin_tpu.params import Params
from margin_tpu.polish import stitcher

from conftest import PARAMS


@pytest.fixture(autouse=True)
def _restore_stitcher_globals():
    yield
    stitcher.set_min_overlap_anchor_pairs(2)
    stitcher.set_pairwise_aligner_kmer_size(None)


def test_stitching_roundtrip():
    """test_stitching (stitchingTest.c:53-139): chunks of
    AAAAAAAAAATTTTTTTTTTCCCCCCCCCCGGGGGGGGGG with overlaps (kmer size 2,
    min 1 anchor pair, boundary 3) reassemble the original sequence —
    regardless of processing order, which the stitcher sorts by ordinal."""
    stitcher.set_pairwise_aligner_kmer_size(2)
    stitcher.set_min_overlap_anchor_pairs(1)
    params = Params.load(PARAMS)
    params.polish.useRunLengthEncoding = False
    params.polish.chunkBoundary = 3

    sequence = "AAAAAAAAAATTTTTTTTTTCCCCCCCCCCGGGGGGGGGG"
    chunks = ["AAAA", "AAAAAAAAAAT", "AAATTT", "AAATTTTTTTTTTCCCCC",
              "TTTCCCCCCCCCCG", "CGGGGGGGGGG", ""]

    rng = random.Random(4)
    for _ in range(10):
        records = [("seq1", i, c) for i, c in enumerate(chunks)]
        rng.shuffle(records)  # stitch_sequences sorts by chunk ordinal
        out = stitcher.stitch_sequences(records, params)
        assert out == [("seq1", sequence)]


def test_merge_contig_chunks():
    """test_mergeContigChunks (stitchingTest.c:148-160): boundary 16."""
    params = Params.load(PARAMS)
    params.polish.useRunLengthEncoding = False
    params.polish.chunkBoundary = 16
    chunks = [
        "A" * 32 + "C" * 16,
        "A" * 16 + "C" * 32 + "G" * 16,
        "C" * 16 + "G" * 32 + "T" * 16,
        "G" * 16 + "T" * 32,
    ]
    records = [("TestContig", i, c) for i, c in enumerate(chunks)]
    out = stitcher.stitch_sequences(records, params)
    assert out == [("TestContig", "A" * 32 + "C" * 32 + "G" * 32 + "T" * 32)]
