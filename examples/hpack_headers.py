"""Downstream-consumer example: HPACK-style header compression.

The reference's downstream consumer is aws-c-http's HPACK implementation
(reference: builder.json:6-8; README.md:176-183 documents the trailing-
padding inspection HPACK requires). This example exercises the same usage
pattern against this framework: per-header-field Huffman coding with the
static table, EOS padding of 0xFF (all-ones, per RFC 7541 §5.2), and the
decoder-side padding validity check.

Run: python examples/hpack_headers.py
"""

import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import tpu_huffman as th  # noqa: E402


def hpack_encode_field(value: bytes, table: th.HuffmanTable) -> bytes:
    """Huffman-encode one header field value (EOS padding 0xFF)."""
    return th.encode(value, table, eos_padding=0xFF)


def hpack_decode_field(blob: bytes, table: th.HuffmanTable) -> bytes:
    """Decode one field, enforcing RFC 7541 §5.2 padding validity."""
    dec = th.HuffmanDecoder(table)
    out = dec.decode_chunk(blob).data
    if not dec.padding_is_all_ones():
        raise ValueError("HPACK: padding is not EOS-prefix (all ones)")
    return out


def main():
    # The real RFC 7541 Appendix B code (what aws-c-http ships); swap in
    # th.load_static_test_table() for the reference repo's test table.
    table = th.load_hpack_table()
    headers = {
        b":method": b"GET",
        b":path": b"/index.html?q=huffman+codec",
        b"host": b"www.example.com",
        b"user-agent": b"tpu-huffman/0.1 (jax; pallas)",
        b"accept-encoding": b"gzip, deflate, br",
    }
    total_raw = total_enc = 0
    for name, value in headers.items():
        for field in (name, value):
            blob = hpack_encode_field(field, table)
            back = hpack_decode_field(blob, table)
            assert back == field, field
            total_raw += len(field)
            total_enc += len(blob)
    print(f"headers: {total_raw} B raw -> {total_enc} B encoded "
          f"({100 * total_enc / total_raw:.1f}%)  round-trip + padding checks OK")

    # A zero-padded (invalid per HPACK) stream must be rejected. Use a
    # payload whose bit length isn't byte-aligned so padding exists.
    payload = next(
        p for p in (b"a", b"x", b"ab", b"abc", b"abcd")
        if int(table.lengths[list(p)].sum()) % 8
    )
    bad = th.encode(payload, table, eos_padding=0x00)
    try:
        hpack_decode_field(bad, table)
    except ValueError:
        print("zero-padded stream correctly rejected")
    else:
        raise AssertionError("invalid padding not detected")


if __name__ == "__main__":
    main()
