"""Arbitrary (non-canonical) prefix-free tables on the parallel decodes.

The reference generator accepts ANY prefix tree (reference:
source/huffman_generator/generator.c:236-278), not just canonical ones.
The lane decode (ops/lanes.py) looks symbols up in the table's two-level
LUT, which any prefix-free table has, so the indexed and the self-sync
decoders handle these tables on the same path as canonical ones.

Non-monotone tables are produced by a random prefix-tree automorphism
(flip each node's children by a pseudorandom bit of its prefix) — exactly
the degree of freedom the reference's generator tolerates: it preserves
prefix-freeness and code lengths while destroying the consecutive-codes
structure of canonical codes.
"""

import numpy as np
import pytest

import tpu_huffman as th
from tpu_huffman import oracle
from tpu_huffman.ops import lanes, selfsync
from tpu_huffman.testing import tree_shuffle


@pytest.fixture(scope="module")
def shuffled():
    base = th.load_static_test_table()
    t = tree_shuffle(base, 42)
    # genuinely non-canonical: same lengths, other codes
    assert (t.lengths == base.lengths).all()
    assert (t.patterns != base.patterns).any()
    return t


def test_lane_table_for_nonmonotone(shuffled):
    lt = lanes.LaneTable.for_table(shuffled)
    assert lt.root_bits == shuffled.root_bits == 10
    assert not lt.has_l1  # 10-bit codes fit the root level
    np.testing.assert_array_equal(lt.lut0 & 0xFF, shuffled.l0_bits & 0xFF)
    np.testing.assert_array_equal(lt.lut0 >> 8, shuffled.l0_val)
    assert lt != lanes.LaneTable(th.load_static_test_table())
    assert selfsync.supports(shuffled)


@pytest.mark.parametrize("seed", [1, 9])
def test_lane_lookup_matches_lut_decode(seed):
    """The lane decode's packed lookup == the table's scalar LUT decode on
    every window probed, across table shapes (incl. the 30-bit HPACK
    table, shuffled, whose long codes take the level-1 subtables)."""
    import jax.numpy as jnp

    tables = [
        tree_shuffle(th.load_static_test_table(), seed),
        tree_shuffle(th.load_hpack_table(), seed),
        th.make_canonical({65: 1, 66: 2, 67: 3, 68: 3}, name="sparse4"),
    ]
    rng = np.random.default_rng(seed)
    for t in tables:
        wins = list(rng.integers(0, 1 << 32, size=3000, dtype=np.uint64))
        wins += [
            int(t.patterns[s]) << (32 - int(t.lengths[s]))
            for s in range(256)
            if t.lengths[s]
        ]
        lt = lanes.LaneTable(t)
        w = jnp.asarray(np.asarray(wins, np.uint64).astype(np.uint32))
        sym, ln = lanes._lookup(
            jnp.asarray(lt.lut0), jnp.asarray(lt.lut1), w, lt.root_bits,
            lt.has_l1,
        )
        sym, ln = np.asarray(sym), np.asarray(ln)
        for k, win in enumerate(map(int, wins)):
            want_sym, want_ln = t.decode_window(win)
            assert (int(sym[k]) if want_ln else 0, int(ln[k])) == (
                want_sym, want_ln
            ), (t.name, hex(win))


@pytest.mark.slow
def test_indexed_kernel_roundtrip_nonmonotone(shuffled):
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, size=700, dtype=np.uint8).tobytes()
    enc, idx = th.encode_with_index(data, shuffled, block_symbols=8)
    assert th.decode_indexed(enc, idx, shuffled, impl="interpret") == data
    # bytes match the reference-semantics C++ oracle
    assert oracle.oracle_encode(data, shuffled) == enc


@pytest.mark.slow
def test_indexed_poison_nonmonotone(shuffled):
    """Corrupt stream under a non-canonical table raises like the
    reference (source/huffman.c:246)."""
    data = bytes(range(256)) * 2
    enc, idx = th.encode_with_index(data, shuffled, block_symbols=8)
    bad_roots = np.flatnonzero(shuffled.l0_bits == 0)
    assert bad_roots.size  # static table is Kraft-incomplete
    off = int(idx.bit_offsets[1])
    total = len(enc) * 8
    bits = int.from_bytes(enc, "big")
    w = shuffled.root_bits
    mask = ((1 << w) - 1) << (total - off - w)
    bits = (bits & ~mask) | (int(bad_roots[0]) << (total - off - w))
    with pytest.raises(th.UnknownSymbolError):
        th.decode_indexed(
            bits.to_bytes(len(enc), "big"), idx, shuffled, impl="interpret"
        )


@pytest.mark.slow
def test_selfsync_foreign_stream_nonmonotone(shuffled):
    """Foreign (un-indexed) stream from the oracle encoder decodes on the
    self-sync lane kernel (tiny segments, Pallas interpreter).

    The comparison target is the ORACLE's decode, not the plaintext: for
    this shuffled table the all-ones EOS padding itself completes a 5-bit
    code, and the reference semantics decode it as an extra symbol (the
    reference leaves padding validation to the caller, README.md:176-183).
    """
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, size=1200, dtype=np.uint8).tobytes()
    enc = oracle.oracle_encode(data, shuffled)
    expected = oracle.oracle_decode(enc, shuffled)
    assert expected[: len(data)] == data  # padding adds at most a suffix
    assert selfsync.selfsync_decode(
        enc, shuffled, seg_words=4, impl="interpret"
    ) == expected


def test_sequential_decode_nonmonotone(shuffled):
    """th.decode (the sequential scan for short streams) handles
    non-canonical tables."""
    data = b"arbitrary prefix trees, as the reference generator accepts"
    assert th.decode(th.encode(data, shuffled), shuffled) == data
