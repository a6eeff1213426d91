"""Indexed decode through the lane kernel (Pallas interpreter on the CPU).

Every index block is one lane of the lane decode (ops/lanes.py); on the GPU
the kernel is compiled through Triton, here the interpreter runs the same
kernel body. Bit-level behavior must match the sequential decoder.
"""

import numpy as np
import pytest

import tpu_huffman as th
from tpu_huffman.ops import lanes
from tpu_huffman.tables import CodeSpec, HuffmanTable


def _decode(enc, idx, table):
    return th.decode_indexed(enc, idx, table, impl="interpret")


@pytest.fixture(scope="module")
def table():
    return th.load_static_test_table()


def test_non_monotone_table_on_fast_path():
    # Codes 00, 01, 11: length-2 codes {0, 1, 3} are not consecutive; the
    # LUT decode handles any prefix tree (the reference generator accepts
    # arbitrary prefix trees, generator.c:236-278).
    t = HuffmanTable.from_specs(
        [CodeSpec(97, 2, 0), CodeSpec(98, 2, 1), CodeSpec(99, 2, 3)], name="gap"
    )
    data = b"abcabccba"
    enc, idx = th.encode_with_index(data, t, block_symbols=4)
    assert _decode(enc, idx, t) == data
    assert th.decode_indexed(enc, idx, t) == data


@pytest.mark.parametrize("k", [8, 16])
@pytest.mark.parametrize("n", [5, 64, 1000])
def test_pallas_matches_sequential(table, k, n):
    rng = np.random.default_rng(n * 31 + k)
    data = rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
    enc, idx = th.encode_with_index(data, table, block_symbols=k)
    out = _decode(enc, idx, table)
    assert out == data
    assert out == th.decode(enc, table)


def test_pallas_canonical_custom_table():
    # Kraft-complete mix: 2x2bit + 4x4bit + 8x6bit + 16x7bit = 1.0
    lens = {}
    sym = 0
    for length, count in ((2, 2), (4, 4), (6, 8), (7, 16)):
        for _ in range(count):
            lens[sym] = length
            sym += 1
    t = th.make_canonical(lens, name="c8")
    rng = np.random.default_rng(9)
    data = rng.integers(0, sym, size=333, dtype=np.uint8).tobytes()
    enc, idx = th.encode_with_index(data, t, block_symbols=8)
    assert _decode(enc, idx, t) == data


def test_decode_indexed_dispatches_to_lanes(table, monkeypatch):
    seen = {}
    orig = lanes.decode_lanes

    def spy(*a, **k):
        seen["impl"] = k["impl"]
        return orig(*a, **k)

    monkeypatch.setattr(lanes, "decode_lanes", spy)
    data = b"dispatch-check" * 10
    enc, idx = th.encode_with_index(data, table, block_symbols=16)
    assert th.decode_indexed(enc, idx, table) == data
    assert seen["impl"] == "xla"  # the CPU backend's plain path


def test_pallas_32bit_code_table():
    # MAX_CODE_BITS=32 codes are legal (reference: source/huffman.c:10):
    # a 32-bit code reads a whole window and its level-1 subtable is 20
    # bits wide. Kraft-complete: 1x1 + 30 descending + 2x32.
    lens = {0: 1}
    for i in range(1, 31):
        lens[i] = i + 1
    lens[31] = 32
    lens[32] = 32
    t = th.make_canonical(lens, name="deep32")
    assert t.max_len == 32
    rng = np.random.default_rng(5)
    # Bias toward the deep symbols so 32-bit codes are dense.
    data = rng.integers(25, 33, size=257, dtype=np.uint8).tobytes()
    enc, idx = th.encode_with_index(data, t, block_symbols=8)
    assert _decode(enc, idx, t) == data
    assert th.decode(enc, t) == data


@pytest.mark.parametrize("n", [64, 1000, 4096, 4095])
def test_dual_chain_pairing(table, n):
    """Odd block counts and partial tails: output must match the
    sequential decoder."""
    rng = np.random.default_rng(n * 7 + 1)
    data = rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
    enc, idx = th.encode_with_index(data, table, block_symbols=16)
    assert _decode(enc, idx, table) == data


def test_dual_chain_deep_table():
    lens = {}
    sym = 0
    budget = 1.0
    for L in range(5, 18):
        lens[sym] = L
        budget -= 2.0 ** -L
        sym += 1
    import math
    while budget > 2.0 ** -18 + 1e-12:
        lens[sym] = max(2, min(18, int(-math.log2(budget)) + 1))
        budget -= 2.0 ** -lens[sym]
        sym += 1
    t = th.make_canonical(lens, name="deep18")
    rng = np.random.default_rng(9)
    data = rng.integers(0, sym, size=3000, dtype=np.uint8).tobytes()
    enc, idx = th.encode_with_index(data, t, block_symbols=16)
    assert _decode(enc, idx, t) == data
    assert th.decode(enc, t) == data


def test_dual_chain_poison_raises(table):
    rng = np.random.default_rng(4)
    data = rng.integers(0, 256, size=2000, dtype=np.uint8).tobytes()
    enc, idx = th.encode_with_index(data, table, block_symbols=16)
    bad = bytearray(enc)
    # A 16-byte zero run guarantees some symbol window starts inside it,
    # and 00000 is an invalid 5-bit prefix in the static table.
    bad[37:53] = bytes(16)
    with pytest.raises(th.UnknownSymbolError):
        _decode(bytes(bad), idx, table)
    with pytest.raises(th.UnknownSymbolError):
        th.decode_indexed(bytes(bad), idx, table)
