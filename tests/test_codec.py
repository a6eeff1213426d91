"""Codec tests: golden-byte KATs, round-trips, indexed parallel decode.

Reference tiers 2 and 4 (SURVEY.md §4): buffer-level known answers
(tests/huffman_test.c:62-115, 222-273) and transitive round-trips
(tests/huffman_test.c:387-427).
"""

import numpy as np
import pytest

import tpu_huffman as th

from golden import (
    ALL_CODES,
    ALL_CODES_ENCODED,
    EVEN_BYTES,
    EXACT_FIT_1BYTE,
    EXACT_FIT_2BYTE,
    URL,
    URL_ENCODED,
)


@pytest.fixture(scope="session")
def table():
    return th.load_static_test_table()


def test_encode_url_golden(table):
    assert th.encode(URL, table) == URL_ENCODED
    assert th.get_encoded_length(URL, table) == len(URL_ENCODED)


def test_encode_all_codes_golden(table):
    assert th.encode(ALL_CODES, table) == ALL_CODES_ENCODED
    assert th.get_encoded_length(ALL_CODES, table) == len(ALL_CODES_ENCODED)


def test_encode_exact_fit(table):
    data, expected = EXACT_FIT_1BYTE
    assert th.encode(data, table) == expected
    data, expected = EXACT_FIT_2BYTE
    assert th.encode(data, table) == expected


def test_decode_url_golden(table):
    assert th.decode(URL_ENCODED, table) == URL


def test_decode_all_codes_golden(table):
    assert th.decode(ALL_CODES_ENCODED, table) == ALL_CODES


def test_transitive(table):
    enc = th.encode(URL, table)
    assert len(enc) == len(URL_ENCODED)
    assert th.decode(enc, table) == URL


def test_transitive_even_bytes(table):
    """'cdfh' encodes to exactly 3 bytes: no padding path at all
    (reference tests/huffman_test.c:401-412)."""
    data, nbytes = EVEN_BYTES
    enc = th.encode(data, table)
    assert len(enc) == nbytes
    assert th.decode(enc, table) == data


def test_empty_input(table):
    assert th.encode(b"", table) == b""
    assert th.decode(b"", table) == b""
    assert th.get_encoded_length(b"", table) == 0


def test_transitive_all_bytes(table):
    data = bytes(range(256)) * 4
    enc = th.encode(data, table)
    assert th.decode(enc, table) == data


def test_encode_unknown_symbol():
    t = th.make_canonical({65: 1, 66: 2, 67: 3, 68: 3})
    with pytest.raises(th.UnknownSymbolError) as ei:
        th.encode(b"ABXC", t)
    assert ei.value.index == 2
    assert ei.value.symbol == ord("X")


def test_decode_unknown_symbol():
    # Sparse table: only a few 4-bit codes; an unmatched prefix with >= 32
    # bits of input remaining must raise (reference source/huffman.c:246).
    t = th.make_canonical({0: 4, 1: 4, 2: 4})
    bad = bytes([0xFF] * 8)  # prefix 1111 matches nothing
    with pytest.raises(th.UnknownSymbolError):
        th.decode(bad, t)


def test_decode_trailing_padding_skipped(table):
    """Padding bits at the stream tail decode to nothing
    (reference source/huffman.c:248-255)."""
    enc = th.encode(b"w", table)  # 6-bit code + 2 bits of 0xFF padding
    assert len(enc) == 1
    assert th.decode(enc, table) == b"w"


def test_custom_eos_padding(table):
    """eos_padding is a per-encoder knob (reference huffman.h:66, default
    0xFF at source/huffman.c:19)."""
    enc_ff = th.encode(b"w", table)
    enc_00 = th.encode(b"w", table, eos_padding=0x00)
    enc_aa = th.encode(b"w", table, eos_padding=0xAA)
    # 'w' is the 6-bit code 100111; the low 2 bits of the byte are padding,
    # taken from the LOW bits of eos_padding (reference huffman.c:71-76,178-184).
    assert enc_ff == bytes([0b10011111])
    assert enc_00 == bytes([0b10011100])
    assert enc_aa == bytes([0b10011110])


def test_indexed_encode_matches_plain(table):
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, size=5000, dtype=np.uint8).tobytes()
    plain = th.encode(data, table)
    indexed, idx = th.encode_with_index(data, table, block_symbols=256)
    assert plain == indexed
    assert idx.total_symbols == 5000
    assert idx.bit_offsets[0] == 0
    assert (np.diff(idx.bit_offsets) > 0).all()


def test_indexed_decode_roundtrip(table):
    rng = np.random.default_rng(2)
    for n in (1, 255, 256, 257, 4096, 10000):
        data = rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
        enc, idx = th.encode_with_index(data, table, block_symbols=256)
        assert th.decode_indexed(enc, idx, table) == data


def test_indexed_decode_ascii(table):
    data = (b"the quick brown fox jumps over the lazy dog " * 100)[:4000]
    enc, idx = th.encode_with_index(data, table, block_symbols=512)
    assert th.decode_indexed(enc, idx, table) == data
    assert th.decode(enc, table) == data


def test_bucketing_boundary_sizes(table):
    """Exercise the static-shape bucketing edges."""
    rng = np.random.default_rng(3)
    for n in (1, 2, 255, 256, 257, 511, 512, 1023, 1024):
        data = rng.integers(32, 127, size=n, dtype=np.uint8).tobytes()
        enc = th.encode(data, table)
        assert th.decode(enc, table) == data
        assert len(enc) == th.get_encoded_length(data, table)


def test_corpora_deterministic_and_roundtrip():
    """Vendored Canterbury-equivalent generators (BASELINE config 2): same
    bytes on every call, and every category round-trips bit-exactly with a
    corpus-built table."""
    from tpu_huffman import corpora

    table_static = th.load_static_test_table()
    for name, gen in corpora.CATEGORIES.items():
        a = gen(4096, seed=7)
        b = gen(4096, seed=7)
        assert a == b and len(a) == 4096, name
        assert gen(4096, seed=8) != a, name  # seed actually matters
        built = th.build_table(a, max_len=14, name=f"{name}_tbl")
        pad = th.safe_eos_padding(built)
        if pad is not None:
            # a padding byte whose tail can't complete a code: lossless
            enc = th.encode(a, built, eos_padding=pad)
            assert th.decode(enc, built) == a, name
        else:
            # Kraft-complete short-code table: ANY padding can decode (the
            # reference leaves this to the caller, README.md:176-183) —
            # the payload prefix must still be exact.
            enc = th.encode(a, built)
            dec = th.decode(enc, built)
            assert dec[: len(a)] == a, name
            assert len(dec) - len(a) <= 7 // max(built.min_len, 1), name
        assert len(enc) < len(a), f"{name}: not compressible?"
    mix = corpora.canterbury_like(8192, seed=42)
    assert mix == corpora.canterbury_like(8192, seed=42)
    enc = th.encode(mix, table_static)
    assert th.decode(enc, table_static) == mix


def test_encode_with_index_guards_int32_wrap(table, monkeypatch):
    """One indexed encode call carries int32 device bit offsets: inputs
    that may exceed 2^31 encoded bits raise instead of wrapping."""
    from tpu_huffman import stream as stream_mod

    data = bytes(range(256)) * 8
    monkeypatch.setattr(stream_mod, "_ONE_SHOT_BIT_LIMIT", 1 << 12)
    with pytest.raises(ValueError, match="2\\^31"):
        th.encode_with_index(data, table)
    # th.encode auto-segments the same input instead, bit-identically
    assert th.encode(data, table) == th.HuffmanEncoder(table).encode(data)
