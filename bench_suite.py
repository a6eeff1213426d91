"""Extended benchmark suite: one JSON line per config, one GPU process each.

    python bench_suite.py [--mb 8] [--stream-mb 64] [--chunk-mb 1]
                          [--configs canterbury,ascii_text,table_5_30,hpack,streaming]

Configs:
  canterbury   — deterministic Canterbury-equivalent corpus mix
                 (tpu_huffman/corpora.py), encoded with a table built from
                 the corpus (build_table)
  ascii_text   — skewed English-like text, static test table
  table_5_30   — canonical table with code lengths spanning 5..30 bits
  hpack        — RFC 7541 table on HTTP-header-like text
  streaming    — chunked SHORT_BUFFER-protocol round trip, 1 MiB output
                 chunks

Each config runs in a child process, one after the other, so exactly one
process holds the card at a time; this parent never initializes a JAX
backend. Times are host-clock wall times through the public entry points
(bench.py), checked against the C++ oracle.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np


def mixed_lengths_5_30() -> dict[int, int]:
    """256-symbol Kraft-complete length assignment spanning 5..30 bits."""
    lens: dict[int, int] = {}
    sym = 0
    budget = 1.0
    # one symbol at each length 5..29 keeps the deep end populated
    for L in range(5, 30):
        lens[sym] = L
        budget -= 2.0 ** -L
        sym += 1
    # fill the rest at the shallow end greedily
    remaining = 256 - sym - 1
    L = 5
    while remaining > 0:
        while L < 30 and 2.0 ** -L > budget - remaining * 2.0 ** -30 + 1e-18:
            L += 1
        lens[sym] = L
        budget -= 2.0 ** -L
        sym += 1
        remaining -= 1
    # last symbol soaks the leftover budget exactly if possible
    import math

    L_last = max(5, min(30, round(-math.log2(budget)))) if budget > 0 else 30
    while 2.0 ** -L_last > budget + 1e-15:
        L_last += 1
    lens[sym] = L_last
    return lens


def english_like_corpus(n: int, seed: int = 7) -> bytes:
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b" etaoinshrdlcumwfgypbvkjxqz.,;'\"!?-\n", dtype=np.uint8)
    weights = np.array(
        [15, 9, 7, 6, 6, 5, 5, 5, 4, 3, 3, 3, 2, 2, 2, 1.5, 1.5, 1.5, 1.5,
         1.4, 1.2, 0.8, 0.5, 0.1, 0.1, 0.1, 0.05, 0.6, 0.5, 0.2, 0.1, 0.05,
         0.3, 0.1, 0.1, 1.0]
    )
    weights = weights / weights.sum()
    return rng.choice(alphabet, size=n, p=weights).astype(np.uint8).tobytes()


def bench_streaming(table, stream_mb, chunk_mb) -> dict:
    """Chunked SHORT_BUFFER-protocol round trip: capacity-bounded encode,
    fed decode, and capacity-bounded decode drains."""
    import tpu_huffman as th
    from tpu_huffman import oracle

    n = int(stream_mb * (1 << 20))
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
    cap = int(chunk_mb * (1 << 20))

    def encode_all():
        enc = th.HuffmanEncoder(table)
        out, pending = [], data
        while True:
            r = enc.encode_chunk(pending, cap)
            out.append(r.data)
            pending = pending[r.consumed:]
            if r.done:
                return b"".join(out)

    def decode_fed(encoded):
        dec = th.HuffmanDecoder(table)
        return b"".join(
            dec.decode_chunk(encoded[i:i + cap]).data
            for i in range(0, len(encoded), cap)
        )

    def decode_capped(encoded):
        dec = th.HuffmanDecoder(table)
        r = dec.decode_chunk(encoded, capacity=cap)
        out = [r.data]
        while not r.done:
            r = dec.decode_chunk(b"", capacity=cap)
            out.append(r.data)
        return b"".join(out)

    encoded = encode_all()  # warm every shape once
    decode_fed(encoded)
    decode_capped(encoded)
    t0 = time.perf_counter()
    encoded = encode_all()
    t_enc = time.perf_counter() - t0
    assert encoded == oracle.oracle_encode(data, table), "chunked encode != oracle"
    t0 = time.perf_counter()
    assert decode_fed(encoded) == data, "fed decode mismatch"
    t_dec = time.perf_counter() - t0
    t0 = time.perf_counter()
    assert decode_capped(encoded) == data, "capped decode mismatch"
    t_cap = time.perf_counter() - t0
    return {
        "metric": "streaming_chunked_throughput",
        "value": n / (t_enc + t_dec) / 1e9,
        "unit": "GB/s",
        "detail": {
            "encode_gbps": n / t_enc / 1e9,
            "decode_gbps": n / t_dec / 1e9,
            "capped_decode_gbps": n / t_cap / 1e9,
        },
    }


def run_config(config: str, args) -> dict:
    from bench import codec_cell, require_gpu
    from tpu_huffman import cache

    cache.enable()
    device = require_gpu()
    import tpu_huffman as th
    from tpu_huffman import corpora

    n = int(args.mb * (1 << 20))
    if config == "streaming":
        out = bench_streaming(th.load_static_test_table(), args.stream_mb,
                              args.chunk_mb)
    else:
        if config == "canterbury":
            corpus = corpora.canterbury_like(n, seed=42)
            # the table is built from the data (package-merge, <= 14 bits)
            table = th.build_table(corpus, max_len=14, name="canterbury_built")
        elif config == "ascii_text":
            table = th.load_static_test_table()
            corpus = english_like_corpus(n)
        elif config == "table_5_30":
            table = th.make_canonical(mixed_lengths_5_30(), name="mixed_5_30")
            # corpus matched to the table: geometric weights over length
            rng = np.random.default_rng(3)
            lens = table.lengths.astype(np.float64)
            w = np.where(lens > 0, 2.0 ** -lens, 0.0)
            corpus = rng.choice(256, size=n, p=w / w.sum()).astype(np.uint8).tobytes()
        elif config == "hpack":
            table = th.load_hpack_table()
            corpus = corpora.hpack_headers(n)
        else:
            raise SystemExit(f"unknown config {config!r}")
        cell = codec_cell(corpus, table, args.reps)
        out = {
            "metric": f"codec_throughput_{config}",
            "value": cell["codec_gbps"],
            "unit": "GB/s",
            "vs_baseline": cell["codec_gbps"] / cell["oracle_codec_gbps"],
            "detail": cell,
        }
    out["device"] = device
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=float, default=8.0)
    ap.add_argument("--stream-mb", type=float, default=64.0)
    ap.add_argument("--chunk-mb", type=float, default=1.0)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument(
        "--configs", default="canterbury,ascii_text,table_5_30,hpack,streaming"
    )
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()

    configs = args.configs.split(",")
    if args.child:
        print(json.dumps(run_config(configs[0], args)), flush=True)
        return
    rc = 0
    for c in configs:
        sub = subprocess.run(
            [sys.executable, __file__, "--child", "--configs", c,
             "--mb", str(args.mb), "--stream-mb", str(args.stream_mb),
             "--chunk-mb", str(args.chunk_mb), "--reps", str(args.reps)],
            capture_output=True, text=True,
        )
        sys.stdout.write(sub.stdout)
        sys.stdout.flush()
        if sub.returncode:
            sys.stderr.write(sub.stderr)
            rc = sub.returncode
    sys.exit(rc)


if __name__ == "__main__":
    main()
