"""Round-trip test oracles.

Framework equivalents of the reference's shipped test helpers
(reference: source/huffman_testing.c:15-73 ``huffman_test_transitive`` and
source/huffman_testing.c:75-173 ``huffman_test_transitive_chunked``). They
raise AssertionError with the same failure vocabulary so property/fuzz
tests read like the reference's.
"""

from __future__ import annotations

import hashlib

from .stream import HuffmanDecoder, HuffmanEncoder
from .tables import CodeSpec, HuffmanTable


def tree_shuffle(table: HuffmanTable, seed: int) -> HuffmanTable:
    """Random prefix-tree automorphism: flip each node's children by a
    pseudorandom bit of its prefix. Keeps code lengths and prefix-freeness
    and destroys the consecutive-codes structure of a canonical table —
    exactly the freedom the reference generator tolerates
    (source/huffman_generator/generator.c:236-278)."""

    def flip(prefix: str) -> int:
        return hashlib.sha256((str(seed) + prefix).encode()).digest()[0] & 1

    specs = []
    for s in table.specs():
        bits = format(s.pattern, f"0{s.num_bits}b")
        out = ""
        for b in bits:
            out += str(int(b) ^ flip(out))
        specs.append(CodeSpec(s.symbol, s.num_bits, int(out, 2)))
    return HuffmanTable.from_specs(specs, name=table.name + "_shuf")


def transitive(
    table: HuffmanTable, data: bytes, encoded_size: int | None = None
) -> None:
    """One-shot encode -> decode -> compare (reference huffman_testing.c:15-73).

    ``encoded_size`` of None skips the exact-size check (reference passes 0).
    """
    enc = HuffmanEncoder(table)
    dec = HuffmanDecoder(table)
    encoded = enc.encode(data)
    if encoded_size is not None and len(encoded) != encoded_size:
        raise AssertionError(
            f"encoded length is incorrect: {len(encoded)} != {encoded_size}"
        )
    expected = enc.encoded_length(data)
    if len(encoded) != expected:
        raise AssertionError(
            f"encoded length disagrees with get_encoded_length: "
            f"{len(encoded)} != {expected}"
        )
    out = dec.decode(encoded)
    if len(out) != len(data):
        raise AssertionError(f"decode output size incorrect: {len(out)} != {len(data)}")
    if out != bytes(data):
        raise AssertionError("decoded data does not match input data")


def transitive_chunked(
    table: HuffmanTable,
    data: bytes,
    encoded_size: int | None,
    output_chunk_size: int,
) -> None:
    """Chunked-output round trip (reference huffman_testing.c:75-173).

    Grows the output budget by ``output_chunk_size`` per call and loops on
    the SHORT_BUFFER-equivalent ``done=False`` until the stream completes,
    for both encode and decode.
    """
    enc = HuffmanEncoder(table)
    dec = HuffmanDecoder(table)

    encoded = bytearray()
    remaining = bytes(data)
    while True:
        res = enc.encode_chunk(remaining, output_chunk_size)
        if remaining and not res.data:
            raise AssertionError("encode didn't write any data")
        encoded.extend(res.data)
        remaining = remaining[res.consumed :]
        if res.done:
            if remaining:
                raise AssertionError("encode done with input left over")
            break
    if encoded_size is not None and len(encoded) != encoded_size:
        raise AssertionError(
            f"encoded length is incorrect: {len(encoded)} != {encoded_size}"
        )

    output = bytearray()
    to_decode: bytes | bytearray = bytes(encoded)
    while True:
        budget = output_chunk_size
        if len(output) + budget > len(data):
            budget = len(data) - len(output)
        res = dec.decode_chunk(to_decode, budget)
        to_decode = b""  # decoder retains unread input internally
        if not res.done and not res.data and budget:
            raise AssertionError("decode didn't write any data")
        output.extend(res.data)
        if res.done:
            break
    if len(output) != len(data):
        raise AssertionError(
            f"decode output size incorrect: {len(output)} != {len(data)}"
        )
    if bytes(output) != bytes(data):
        raise AssertionError("decoded data does not match input data")


def transitive_chunked_input(
    table: HuffmanTable, data: bytes, input_chunk_size: int
) -> None:
    """Partial-*input* decode sweep (reference tests/huffman_test.c:275-314):
    encode whole, then feed the encoded bytes to the decoder in chunks."""
    enc = HuffmanEncoder(table)
    dec = HuffmanDecoder(table)
    encoded = enc.encode(data)
    output = bytearray()
    for i in range(0, len(encoded), input_chunk_size):
        res = dec.decode_chunk(encoded[i : i + input_chunk_size], None)
        output.extend(res.data)
    if bytes(output) != bytes(data):
        raise AssertionError("decoded data does not match input data")
