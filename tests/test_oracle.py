"""Bit-exactness of the JAX paths against the C++ oracle (cpp/).

The oracle mirrors the reference C semantics exactly (golden vectors from
reference tests/huffman_test.c:20-37 are asserted inside cpp/tests/ as well);
here every JAX kernel result is compared byte-for-byte against it, which is
the SURVEY.md §4 "always compare against the C++ oracle" tier.
"""

import numpy as np
import pytest

import tpu_huffman as th
from tpu_huffman import oracle

from golden import STEP_SIZES, URL

pytestmark = pytest.mark.skipif(
    not oracle.oracle_available(), reason="C++ oracle could not be built"
)


@pytest.fixture(scope="module")
def table():
    return th.load_static_test_table()


@pytest.fixture(scope="module")
def otable(table):
    return oracle.OracleTable(table)


def _random_corpus(seed=7, n=2048):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()


def test_encode_matches_oracle(table, otable):
    enc = oracle.OracleEncoder(otable)
    for data in (URL, b"a", b"cdfh", _random_corpus()):
        assert th.encode(data, table) == enc.encode(data)
        enc.reset()


def test_decode_matches_oracle(table, otable):
    data = _random_corpus(seed=11)
    encoded = th.encode(data, table)
    assert th.decode(encoded, table) == oracle.OracleDecoder(otable).decode(encoded)


def test_oracle_roundtrip_of_device_stream(table, otable):
    """Device-encoded bytes must decode on the C++ (reference-semantics)
    side."""
    data = _random_corpus(seed=13, n=4096)
    encoded, index = th.encode_with_index(data, table)
    assert oracle.OracleDecoder(otable).decode(encoded) == data
    assert th.decode_indexed(encoded, index, table) == data


def test_streaming_encoder_parity(table, otable):
    """Chunked-output protocol: identical bytes and carry at every step size."""
    data = _random_corpus(seed=17, n=512)
    for step in STEP_SIZES:
        ours = th.HuffmanEncoder(table)
        ref = oracle.OracleEncoder(otable)
        got_ours, got_ref = b"", b""
        pending = data
        for _ in range(100000):
            res = ours.encode_chunk(pending, step)
            got_ours += res.data
            pending = pending[res.consumed :]
            if res.done:
                break
        pending = data
        for _ in range(100000):
            out, consumed, done = ref.encode_chunk(pending, step)
            got_ref += out
            pending = pending[consumed:]
            if done:
                break
        assert got_ours == got_ref, f"step={step}"


def test_streaming_decoder_parity(table, otable):
    data = _random_corpus(seed=19, n=512)
    encoded = th.encode(data, table)
    for step in (1, 7, 64):
        ours = th.HuffmanDecoder(table)
        ref = oracle.OracleDecoder(otable)
        got_ours, got_ref = b"", b""
        for i in range(0, len(encoded), step):
            got_ours += ours.decode_chunk(encoded[i : i + step]).data
        pending = encoded
        while pending:
            out, consumed, done = ref.decode_chunk(pending, len(data) + 8)
            got_ref += out
            pending = pending[consumed:]
            if done and not pending:
                break
        assert got_ours == got_ref == data, f"step={step}"


def test_custom_table_parity():
    """Canonical 5-30 bit table (BASELINE.json config 3) agrees end-to-end."""
    lens = {i: 5 + (i * 7) % 26 for i in range(64)}  # lengths in [5, 30]
    table = th.make_canonical(lens, name="mixed530")
    otable = oracle.OracleTable(table)
    rng = np.random.default_rng(23)
    data = rng.integers(0, 64, size=1024, dtype=np.uint8).tobytes()
    ours = th.encode(data, table)
    ref = oracle.OracleEncoder(otable).encode(data)
    assert ours == ref
    assert th.decode(ours, table) == data
    assert oracle.OracleDecoder(otable).decode(ref) == data


def test_unknown_symbol_parity(table, otable):
    sparse = th.make_canonical({97: 1, 98: 2, 99: 2}, name="abc")
    osparse = oracle.OracleTable(sparse)
    with pytest.raises(th.UnknownSymbolError):
        th.encode(b"abz", sparse)
    with pytest.raises(th.UnknownSymbolError):
        oracle.OracleEncoder(osparse).encode(b"abz")


def test_eos_padding_parity(table, otable):
    """Non-default eos_padding (reference huffman.h:66) must match too."""
    for pad in (0x00, 0x5A):
        ours = th.encode(URL, table, eos_padding=pad)
        ref = oracle.OracleEncoder(otable, eos_padding=pad).encode(URL)
        assert ours == ref


def test_encoder_carry_parity_every_chunk(table, otable):
    """overflow_bits parity with the C++ oracle after EVERY chunk of the
    step-size sweep (reference behavior: huffman_test.c:117-165) — not just
    the final bytes."""
    data = _random_corpus(seed=29, n=384)
    for step in STEP_SIZES:
        ours = th.HuffmanEncoder(table)
        ref = oracle.OracleEncoder(otable)
        pend_o, pend_r = data, data
        for _ in range(100000):
            res = ours.encode_chunk(pend_o, step)
            out_r, cons_r, done_r = ref.encode_chunk(pend_r, step)
            pend_o = pend_o[res.consumed :]
            pend_r = pend_r[cons_r:]
            assert res.data == out_r, f"step={step}: chunk bytes diverge"
            # The carry IS the stream state (reference huffman.h:69); it
            # must match bit-for-bit at every boundary.
            assert ours.overflow_bits == ref.overflow_bits, f"step={step}"
            assert res.done == done_r
            if res.done:
                break
        assert ours.overflow_bits == (0, 0)


def test_decoder_leftover_parity_every_chunk(table, otable):
    """Decoder tail-bits parity with the C++ oracle at every input-chunk
    boundary (reference: working_bits/num_bits, huffman.h:82-83; partial
    input sweep huffman_test.c:275-314)."""
    data = _random_corpus(seed=31, n=384)
    encoded = th.encode(data, table)
    for step in (1, 2, 4, 8, 16, 32, 64, 128):
        ours = th.HuffmanDecoder(table)
        ref = oracle.OracleDecoder(otable)
        got_o = b""
        got_r = b""
        for i in range(0, len(encoded), step):
            chunk = encoded[i : i + step]
            got_o += ours.decode_chunk(chunk).data
            pending = chunk
            while pending:
                out_r, cons_r, _done = ref.decode_chunk(pending, len(data))
                got_r += out_r
                pending = pending[cons_r:]
                if cons_r == 0:
                    break
            assert got_o == got_r, f"step={step} at byte {i}"
            # State parity: our retained remainder viewed as MSB-first bits
            # equals the oracle's working-bits window at this boundary.
            v_o, n_o = ours.leftover_bits
            v_r64, n_r = ref.leftover_bits
            assert n_o == n_r, f"step={step} at byte {i}: bit counts differ"
            # Oracle exposes working_bits as a 64-bit MSB-aligned window.
            v_r = (v_r64 >> (64 - n_r)) if n_r else 0
            assert v_o == v_r, f"step={step} at byte {i}: tail bits differ"
        assert got_o == data
