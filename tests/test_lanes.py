"""The lane decode kernel against its plain reference (CPU tier).

ops/lanes.py has one step definition and three implementations; here the
Pallas kernel runs under the interpreter (``impl="interpret"``) and must
return exactly the arrays of the ``lax.scan`` reference (``impl="xla"``)
under both stop rules, over table shapes from 5-bit to 32-bit codes and
non-canonical trees, at several block sizes with partial tails.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import tpu_huffman as th
from tpu_huffman.ops import lanes
from tpu_huffman.ops.bitpack import words_from_bytes_np
from tpu_huffman.testing import tree_shuffle


def _wide_table():
    """Kraft-complete canonical table with code lengths 5..30."""
    lens = {}
    budget = 1.0
    sym = 0
    for L in range(5, 30):
        for _ in range(2):
            lens[sym] = L
            budget -= 2.0 ** -L
            sym += 1
    while budget >= 2.0 ** -8 and sym < 255:
        lens[sym] = 8
        budget -= 2.0 ** -8
        sym += 1
    lens[sym] = 30
    return th.make_canonical(lens, name="wide5_30")


def _deep32_table():
    lens = {0: 1}
    for i in range(1, 31):
        lens[i] = i + 1
    lens[31] = 32
    lens[32] = 32
    return th.make_canonical(lens, name="deep32")


TABLES = {
    "static": th.load_static_test_table,
    "rfc7541": th.load_hpack_table,
    "wide5_30": _wide_table,
    "deep32": _deep32_table,
    "nonmonotone": lambda: tree_shuffle(th.load_static_test_table(), 7),
}


@pytest.fixture(scope="module", params=sorted(TABLES))
def table(request):
    return TABLES[request.param]()


def _sample(table, n, seed):
    syms = np.flatnonzero(table.lengths > 0)
    rng = np.random.default_rng(seed)
    # bias half the draws toward the longest codes so deep LUT entries run
    deep = syms[table.lengths[syms] >= table.lengths[syms].max() - 1]
    out = rng.choice(syms, size=n).astype(np.uint8)
    out[::2] = rng.choice(deep, size=out[::2].size)
    return out.tobytes()


def _stream(enc):
    w, _ = words_from_bytes_np(enc)
    return jnp.asarray(np.concatenate([w, np.zeros(2, np.uint32)]))


def _both(*args, **kw):
    out = {
        impl: [None if a is None else np.asarray(a)
               for a in lanes.decode_lanes(*args, impl=impl, **kw)]
        for impl in ("xla", "interpret")
    }
    for a, b in zip(out["xla"], out["interpret"]):
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(a, b)
    return out["xla"]


@pytest.mark.parametrize("K", [4, 24, 64])
def test_kernel_matches_scan_count_rule(table, K):
    """Indexed decode: one lane per block, a partial last block."""
    data = _sample(table, 7 * K + K // 2 + 1, K)
    enc, idx = th.encode_with_index(data, table, block_symbols=K)
    off = idx.bit_offsets
    syms, exits, bad, offs, blast = _both(
        _stream(enc), jnp.asarray(off >> 5), jnp.asarray(off & 31),
        jnp.asarray(idx.n_symbols), lanes.LaneTable(table), steps=K,
    )
    assert offs is None and blast is None
    assert (bad == 0).all()
    assert syms.reshape(-1)[: len(data)].tobytes() == data
    # every lane ends where the next block begins
    np.testing.assert_array_equal((exits + 32 * (off >> 5))[:-1], off[1:])


def test_kernel_matches_scan_limit_rule(table):
    """Self-sync segments from aligned starts: symbols, exits, poison and
    per-symbol offsets agree, including lanes that start mid-code."""
    data = _sample(table, 600, 3)
    enc = th.encode(data, table)
    seg_words = 4
    S = len(enc) // (4 * seg_words) - 1
    base = jnp.arange(S, dtype=jnp.int32) * seg_words
    syms, exits, bad, offs, blast = _both(
        _stream(enc), base, jnp.zeros(S, jnp.int32), None,
        lanes.LaneTable(table), steps=132, limit=seg_words * 32,
        emit_offs=True,
    )
    # every step advances >= 1 bit, so 132 slots always reach the limit
    assert (exits >= 128).all()
    assert syms.shape == offs.shape == (S, 132)


def test_limit_rule_stops_at_segment_end():
    t = th.load_static_test_table()
    data = _sample(t, 400, 5)
    enc = th.encode(data, t)
    lt = lanes.LaneTable(t)
    syms, exits, bad, offs, blast = _both(
        _stream(enc), jnp.zeros(1, jnp.int32), jnp.zeros(1, jnp.int32), None,
        lt, steps=40, limit=100, emit_offs=True,
    )
    # the chain from bit 0 is the true chain: it decodes the data's prefix
    lens = t.lengths[np.frombuffer(data, np.uint8)]
    starts = np.cumsum(lens) - lens
    n = int((starts < 100).sum())
    assert syms[0, :n].tobytes() == data[:n]
    assert (syms[0, n:] == 0).all()
    np.testing.assert_array_equal(offs[0, :n], starts[:n])
    assert exits[0] == starts[n] and exits[0] >= 100
    assert bad[0] == 0 and blast[0] == 0


def test_poison_records_first_and_last_invalid():
    """All-zero words: 00000 matches no static-table code, so every step
    is a 1-bit poison step under either stop rule."""
    t = th.load_static_test_table()
    lt = lanes.LaneTable(t)
    zeros = jnp.zeros(64, jnp.uint32)
    syms, exits, bad, offs, blast = _both(
        zeros, jnp.asarray([0, 3]), jnp.asarray([5, 9]), None, lt, steps=8,
        limit=12, emit_offs=True,
    )
    np.testing.assert_array_equal(bad, [6, 10])  # 1 + first invalid bit
    np.testing.assert_array_equal(blast, [12, 12])  # 1 + last invalid bit
    np.testing.assert_array_equal(exits, [12, 12])
    assert (syms == 0).all()
    syms, exits, bad, _o, _b = _both(
        zeros, jnp.asarray([0]), jnp.asarray([2]), jnp.asarray([3]), lt,
        steps=8,
    )
    assert bad[0] == 3 and exits[0] == 5  # three 1-bit steps, then stop


def test_count_rule_inactive_slots_zero():
    t = th.load_static_test_table()
    enc = th.encode(b"hello world", t)
    syms, exits, bad, _o, _b = _both(
        _stream(enc), jnp.zeros(2, jnp.int32), jnp.zeros(2, jnp.int32),
        jnp.asarray([11, 0]), lanes.LaneTable(t), steps=16,
    )
    assert syms[0, :11].tobytes() == b"hello world"
    assert (syms[0, 11:] == 0).all() and (syms[1] == 0).all()
    assert exits[1] == 0


def test_lane_table_packing():
    for t in (th.load_static_test_table(), th.load_hpack_table()):
        lt = lanes.LaneTable.for_table(t)
        assert lanes.LaneTable.for_table(t) is lt
        np.testing.assert_array_equal((lt.lut0 << 24) >> 24, t.l0_bits)
        np.testing.assert_array_equal(lt.lut0 >> 8, t.l0_val)
        np.testing.assert_array_equal(lt.lut1 & 0xFF, t.l1_bits)
        np.testing.assert_array_equal(lt.lut1 >> 8, t.l1_val)
        assert lt == lanes.LaneTable(t) and hash(lt) == hash(lanes.LaneTable(t))
    assert not lanes.LaneTable(th.load_static_test_table()).has_l1
    assert lanes.LaneTable(th.load_hpack_table()).has_l1


def test_decode_lanes_rejects_bad_arguments():
    t = th.load_static_test_table()
    lt = lanes.LaneTable(t)
    z = jnp.zeros(4, jnp.int32)
    w = jnp.zeros(8, jnp.uint32)
    with pytest.raises(ValueError):
        lanes.decode_lanes(w, z, z, None, lt, steps=8, impl="xla")
    with pytest.raises(ValueError):
        lanes.decode_lanes(w, z, z, None, lt, steps=6, limit=32, impl="xla")
    with pytest.raises(ValueError):
        lanes.decode_lanes(w, z, z, z, lt, steps=8, impl="cuda")


def test_decode_indexed_rejects_streams_past_2_36_bits():
    t = th.load_static_test_table()
    enc, idx = th.encode_with_index(b"abc", t)
    import dataclasses

    huge = dataclasses.replace(idx, total_bits=1 << 36)
    with pytest.raises(ValueError):
        th.decode_indexed(enc, huge, t)


def test_word_index_plus_phase_addressing():
    """Lanes address the stream as (word index, bit phase): a lane whose
    block starts deep in the stream decodes from its own word, however
    far the absolute bit offset is from zero."""
    t = th.load_static_test_table()
    data = _sample(t, 3000, 11)
    enc, idx = th.encode_with_index(data, t, block_symbols=100)
    words = _stream(enc)
    off = idx.bit_offsets
    # re-express every lane relative to a word base 7 words earlier
    base = np.maximum((off >> 5) - 7, 0)
    start = off - 32 * base
    syms, _e, bad, _o, _b = _both(
        words, jnp.asarray(base), jnp.asarray(start),
        jnp.asarray(idx.n_symbols), lanes.LaneTable(t), steps=100,
    )
    assert syms.reshape(-1)[:3000].tobytes() == data and (bad == 0).all()
