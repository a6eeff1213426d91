"""Auto-segmentation of oversized one-shot calls.

The device pipelines carry int32 bit offsets, bounding one encode call at
2^31 output bits, and the self-sync dense assembly's scratch scales with
the view size. The reference is size_t-clean at any length
(source/huffman.c:107-129), so oversized one-shot calls now segment
internally: encode drives the capacity protocol (the carry path never
inserts mid-stream padding), decode feeds the streaming decoder. These
tests shrink the thresholds to exercise the seams on small data; the
1 GiB contract runs on the GPU (tests/test_gpu.py).
"""

import numpy as np
import pytest

import tpu_huffman as th
import sys

import tpu_huffman.ops.decode  # noqa: F401  (package re-export shadows it)
from tpu_huffman import stream as stream_mod

decode_mod = sys.modules["tpu_huffman.ops.decode"]


@pytest.fixture(scope="module")
def table():
    return th.load_static_test_table()


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(41)
    return rng.integers(0, 256, size=4000, dtype=np.uint8).tobytes()


def test_oversized_encode_segments_bit_identical(table, data, monkeypatch):
    want = th.encode(data, table)
    # limit 2^13 bits -> seg_cap 256 bytes -> ~16 segments
    monkeypatch.setattr(stream_mod, "_ONE_SHOT_BIT_LIMIT", 1 << 13)
    got = th.encode(data, table)
    assert got == want


def test_oversized_encoder_one_shot_segments(table, data, monkeypatch):
    want = th.HuffmanEncoder(table).encode(data)
    monkeypatch.setattr(stream_mod, "_ONE_SHOT_BIT_LIMIT", 1 << 13)
    res = th.HuffmanEncoder(table).encode_chunk(data, None)
    assert res.done and res.consumed == len(data)
    assert res.data == want


def test_oversized_decode_segments_exact(table, data, monkeypatch):
    enc = th.encode(data, table)
    monkeypatch.setattr(decode_mod, "DECODE_SEGMENT_BYTES", 512)
    assert th.decode(enc, table) == data


def test_oversized_decode_unknown_symbol_still_raises(table, monkeypatch):
    # corrupt a stream against a PARTIAL table: the chunked route must
    # preserve the reference error condition (huffman.c:246)
    t = th.make_canonical({65: 2, 66: 2, 67: 2}, name="partial_seg")
    enc = th.encode(b"ABCAB" * 400, t)
    bad = bytes([enc[0] ^ 0xC0]) + enc[1:]
    monkeypatch.setattr(decode_mod, "DECODE_SEGMENT_BYTES", 256)
    with pytest.raises(th.UnknownSymbolError):
        th.decode(bad, t)
