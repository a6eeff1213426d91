"""Property/fuzz tier (SURVEY.md §4 tier 5).

Python-side analog of the reference's libFuzzer targets
(reference: tests/fuzz/decode.c, transitive.c, transitive_chunked.c):
  - decoding arbitrary bytes must never crash (UnknownSymbolError or clean
    output only),
  - round-trip over arbitrary bytes is lossless,
  - chunked round-trip at arbitrary step sizes is lossless.
Driven by hypothesis; kept small so the interpret-mode kernels stay fast.
"""

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import tpu_huffman as th

TABLE = th.load_static_test_table()
FUZZ = settings(max_examples=30, deadline=None)


@given(data=st.binary(min_size=0, max_size=512))
@FUZZ
def test_decode_arbitrary_bytes_never_crashes(data):
    try:
        out = th.decode(data, TABLE)
    except th.UnknownSymbolError:
        return
    assert isinstance(out, bytes)


@given(data=st.binary(min_size=0, max_size=512))
@FUZZ
def test_roundtrip_lossless(data):
    enc = th.encode(data, TABLE)
    assert th.decode(enc, TABLE) == data


@given(data=st.binary(min_size=1, max_size=256), k=st.sampled_from([4, 8, 16, 32]))
@pytest.mark.slow
@FUZZ
def test_indexed_roundtrip_lossless(data, k):
    enc, idx = th.encode_with_index(data, TABLE, block_symbols=k)
    assert enc == th.encode(data, TABLE)  # index never changes the bytes
    assert th.decode_indexed(enc, idx, TABLE) == data


@given(
    data=st.binary(min_size=1, max_size=200),
    step=st.sampled_from([1, 2, 3, 7, 8, 33, 128]),
)
@FUZZ
def test_chunked_encode_roundtrip(data, step):
    """Reference: fuzz/transitive_chunked.c — grow output chunk by chunk."""
    enc = th.HuffmanEncoder(TABLE)
    out = b""
    pending = data
    for _ in range(10000):
        res = enc.encode_chunk(pending, step)
        out += res.data
        pending = pending[res.consumed :]
        if res.done:
            break
    assert out == th.encode(data, TABLE)
    assert th.decode(out, TABLE) == data


@given(
    data=st.binary(min_size=1, max_size=200),
    step=st.sampled_from([1, 3, 8, 64]),
)
@FUZZ
def test_chunked_decode_roundtrip(data, step):
    enc = th.encode(data, TABLE)
    dec = th.HuffmanDecoder(TABLE)
    out = b""
    for i in range(0, len(enc), step):
        out += dec.decode_chunk(enc[i : i + step]).data
    assert out == data


def _overwrite_bits(enc: bytes, off: int, width: int, value: int) -> bytes:
    """Overwrite ``width`` bits at absolute bit offset ``off`` (MSB-first)."""
    total = len(enc) * 8
    bits = int.from_bytes(enc, "big")
    mask = ((1 << width) - 1) << (total - off - width)
    bits = (bits & ~mask) | (value << (total - off - width))
    return bits.to_bytes(len(enc), "big")


def test_indexed_decode_poison_raises():
    """A corrupt stream under a trusted index must raise UnknownSymbolError
    (reference condition: source/huffman.c:246), not emit silent garbage."""
    data = bytes(range(256)) * 4
    enc, idx = th.encode_with_index(data, TABLE, block_symbols=32)
    # The static table is incomplete (Kraft sum < 1), so invalid root
    # prefixes exist; plant one at block 1's indexed start offset.
    bad_prefix = int(np.flatnonzero(TABLE.l0_bits == 0)[0])
    off = int(idx.bit_offsets[1])
    corrupt = _overwrite_bits(enc, off, TABLE.root_bits, bad_prefix)
    with pytest.raises(th.UnknownSymbolError):
        th.decode_indexed(corrupt, idx, TABLE, impl="interpret")
    # ... and the same through the backend's own path.
    with pytest.raises(th.UnknownSymbolError):
        th.decode_indexed(corrupt, idx, TABLE)
    # The intact stream still round-trips (poison path has no false hits).
    assert th.decode_indexed(enc, idx, TABLE, impl="interpret") == data


@given(pos=st.integers(0, 511), val=st.integers(0, 255))
@settings(max_examples=20, deadline=None)
def test_indexed_decode_mutated_bytes_no_crash(pos, val):
    """Byte mutations under a fixed index: clean output or UnknownSymbolError,
    never a crash (reference fuzz tier: tests/fuzz/decode.c)."""
    data = bytes(range(256)) * 4
    enc, idx = th.encode_with_index(data, TABLE, block_symbols=32)
    mutated = bytearray(enc)
    mutated[pos % len(enc)] = val
    try:
        out = th.decode_indexed(bytes(mutated), idx, TABLE, impl="interpret")
    except th.UnknownSymbolError:
        return
    assert isinstance(out, bytes) and len(out) == len(data)


@given(seed=st.integers(0, 2**31 - 1))
@settings(max_examples=10, deadline=None)
def test_sparse_table_decode_rejects_or_roundtrips(seed):
    """Arbitrary bytes against a sparse table: no crash, correct verdict."""
    sparse = th.make_canonical({65: 1, 66: 2, 67: 3, 68: 3}, name="sparse4")
    rng = np.random.default_rng(seed)
    blob = rng.integers(0, 256, size=64, dtype=np.uint8).tobytes()
    try:
        out = th.decode(blob, sparse)
    except th.UnknownSymbolError:
        return
    assert set(out) <= {65, 66, 67, 68}


@given(seed=st.integers(0, 2**31 - 1))
@settings(max_examples=8, deadline=None)  # each example compiles a fresh kernel
@pytest.mark.slow
def test_random_table_encode_matches_host(seed):
    """Device encode vs the C++ oracle over RANDOM canonical tables and
    random data (guards the cumsum/scatter pack against table-shape edge
    cases the fixed tables don't hit)."""
    rng = np.random.default_rng(seed)
    # random Kraft-complete length assignment over a random alphabet size
    nsym = int(rng.integers(2, 257))
    lens = {}
    budget = 1.0
    for s in range(nsym - 1):
        max_l = min(15, int(-np.log2(max(budget - (nsym - 1 - s) * 2.0**-15, 2.0**-15))) + 1)
        L = int(rng.integers(2, max(3, max_l + 1)))
        while 2.0**-L > budget - (nsym - 1 - s) * 2.0**-15:
            L += 1
        lens[s] = L
        budget -= 2.0**-L
    import math
    L_last = max(1, math.ceil(-math.log2(budget))) if budget > 0 else 15
    lens[nsym - 1] = min(32, L_last)
    try:
        tbl = th.make_canonical(lens)
    except ValueError:
        return  # over-subscribed Kraft sum: not a valid table, skip
    n = int(rng.integers(1, 5000))
    data = rng.integers(0, nsym, size=n, dtype=np.uint8).tobytes()
    from tpu_huffman import oracle

    assert th.encode(data, tbl) == oracle.oracle_encode(data, tbl)
