"""Optimal length-limited table construction (package-merge).

A capability the reference delegates to external tooling; here it is part
of the table compiler. Optimality is checked against the information-
theoretic bound and against unconstrained Huffman cost.
"""

import heapq

import numpy as np
import pytest

import tpu_huffman as th
from tpu_huffman.errors import TableError
from tpu_huffman.tables import optimal_code_lengths


def huffman_cost_unbounded(freqs):
    """Plain Huffman total bit cost (no length limit) via a heap."""
    heap = [f for f in freqs if f > 0]
    heapq.heapify(heap)
    if len(heap) == 1:
        return heap[0]
    cost = 0
    while len(heap) > 1:
        a, b = heapq.heappop(heap), heapq.heappop(heap)
        cost += a + b
        heapq.heappush(heap, a + b)
    return cost


def cost_of(lengths, freqs):
    return int(sum(int(l) * int(f) for l, f in zip(lengths, freqs)))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_matches_unbounded_huffman_when_limit_loose(seed):
    rng = np.random.default_rng(seed)
    freqs = rng.integers(1, 10_000, size=64)
    lens = optimal_code_lengths(freqs, max_len=32)
    assert cost_of(lens[:64], freqs) == huffman_cost_unbounded(freqs.tolist())
    kraft = sum(2.0 ** -l for l in lens if l > 0)
    assert kraft <= 1.0 + 1e-12


def test_length_limit_respected_and_kraft_valid():
    # Exponential frequencies force deep codes; limit must clamp them.
    freqs = [2 ** i for i in range(20)]
    lens = optimal_code_lengths(freqs, max_len=8)
    nz = [l for l in lens if l > 0]
    assert max(nz) <= 8
    assert sum(2.0 ** -l for l in nz) <= 1.0 + 1e-12
    # and the limited cost can't beat the unbounded optimum
    assert cost_of(lens[:20], freqs) >= huffman_cost_unbounded(freqs)


def test_too_many_symbols_for_limit():
    with pytest.raises(TableError):
        optimal_code_lengths(np.ones(256), max_len=7)


def test_build_table_roundtrip():
    rng = np.random.default_rng(5)
    # skewed corpus over a 40-symbol alphabet
    data = rng.choice(
        np.arange(40, dtype=np.uint8), p=np.arange(1, 41) / np.arange(1, 41).sum(),
        size=20_000,
    ).tobytes()
    table = th.build_table(data=data, max_len=12, name="fitted")
    enc = th.encode(data, table)
    assert th.decode(enc, table) == data
    # fitted table must beat the static test table on its own corpus
    static = th.load_static_test_table()
    assert len(enc) < len(th.encode(data, static))
    # absent symbols have no code
    with pytest.raises(th.UnknownSymbolError):
        th.encode(bytes([200]), table)


def test_build_table_single_symbol():
    table = th.build_table(data=b"aaaa", name="mono")
    enc = th.encode(b"aaaa", table)
    assert th.decode(enc, table) == b"aaaa"


def test_built_table_is_range_monotone():
    """Constructed tables are canonical — each code length's codes form one
    consecutive range — and take the lane kernel like any table."""
    from tpu_huffman.ops import lanes

    rng = np.random.default_rng(9)
    data = rng.integers(0, 256, size=10_000, dtype=np.uint8).tobytes()
    table = th.build_table(data=data, max_len=14)
    for L in np.unique(table.lengths[table.lengths > 0]):
        codes = np.sort(table.patterns[table.lengths == L].astype(np.int64))
        assert (np.diff(codes) == 1).all(), L
    lt = lanes.LaneTable(table)
    assert lt.has_l1 == (table.max_len > table.root_bits)
    enc, idx = th.encode_with_index(data[:2000], table, block_symbols=16)
    assert th.decode_indexed(enc, idx, table, impl="interpret") == data[:2000]
