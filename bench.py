"""Codec throughput through the public entry points on one GPU.

    python bench.py [--mb 8] [--reps 5]

Times ``th.encode_with_index``, ``th.decode_indexed`` and ``th.decode``
(a foreign stream: no index) on uniform random bytes with the static test
table. The clock runs from bytes on the host to bytes on the host, so
transfers count. Every output is checked against the C++ oracle, which is
also timed on one CPU core as the baseline. Prints one JSON line labelled
with the device it ran on.

The script refuses to run without a GPU: a CPU number is no device number.
Which cells and metrics the benchmark should have is an open item
(ROADMAP.md, Speed #1).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def require_gpu():
    """The JAX device label; exits non-zero unless the backend is a GPU."""
    import jax

    if jax.default_backend() != "gpu":
        sys.exit(f"no GPU: JAX's default backend is {jax.default_backend()!r}")
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def timed(fn, reps: int):
    """(cold seconds, best warm seconds, last result) of ``fn()``; every
    call returns host bytes, so the device work is complete."""
    t0 = time.perf_counter()
    out = fn()
    cold = time.perf_counter() - t0
    warm = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        warm = min(warm, time.perf_counter() - t0)
    return cold, warm, out


def codec_cell(data: bytes, table, reps: int) -> dict:
    """Encode, indexed decode and foreign decode of ``data``, each checked
    against the oracle; returns the times and rates."""
    import tpu_huffman as th
    from tpu_huffman import oracle

    n = len(data)
    want = oracle.oracle_encode(data, table)
    c_enc, w_enc, (enc, idx) = timed(
        lambda: th.encode_with_index(data, table), reps
    )
    assert enc == want, "device encode != C++ oracle bytes"
    c_dec, w_dec, out = timed(lambda: th.decode_indexed(enc, idx, table), reps)
    assert out == data, "indexed decode mismatch"
    c_for, w_for, out = timed(lambda: th.decode(enc, table), reps)
    assert out == data, "foreign decode mismatch"
    ot = oracle.OracleTable(table)
    t0 = time.perf_counter()
    oracle.OracleEncoder(ot).encode(data)
    o_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    oracle.OracleDecoder(ot).decode(want)
    o_dec = time.perf_counter() - t0
    return {
        "bytes": n,
        "ratio": len(enc) / n,
        "encode_gbps": n / w_enc / 1e9,
        "decode_indexed_gbps": n / w_dec / 1e9,
        "decode_foreign_gbps": n / w_for / 1e9,
        "codec_gbps": n / (w_enc + w_dec) / 1e9,
        "oracle_codec_gbps": n / (o_enc + o_dec) / 1e9,
        "cold_s": {"encode": c_enc, "decode_indexed": c_dec,
                   "decode_foreign": c_for},
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=float, default=8.0, help="corpus size in MiB")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=2024)
    args = ap.parse_args()

    from tpu_huffman import cache

    cache.enable()
    device = require_gpu()
    import tpu_huffman as th

    table = th.load_static_test_table()
    rng = np.random.default_rng(args.seed)
    data = rng.integers(0, 256, size=int(args.mb * (1 << 20)), dtype=np.uint8)
    cell = codec_cell(data.tobytes(), table, args.reps)
    print(json.dumps({
        "metric": "codec_throughput_static_table",
        "value": cell["codec_gbps"],
        "unit": "GB/s",
        "vs_baseline": cell["codec_gbps"] / cell["oracle_codec_gbps"],
        "device": device,
        "detail": cell,
    }))


if __name__ == "__main__":
    main()
