"""Run the codec once on NVIDIA GPUs through its public entry points.

    python3 chip_smoke.py [--seed N]        # one card, every phase
    python3 chip_smoke.py --chips 4         # MeshCodec over 4 cards only
    python3 chip_smoke.py --rehearse        # tiny sizes on any backend

Data comes from ``--seed``; every output is compared byte for byte with the
C++ oracle (tpu_huffman/oracle.py, built with g++ from cpp/src on first
use). Phases on one card:

  1. bulk     1 GiB uniform random bytes, static test table: th.encode ==
              oracle (auto-segmented past 2^31 bits), th.decode == input
              (self-synchronizing lane decode);
  2. indexed  128 MiB: th.encode_with_index == oracle, th.decode_indexed;
  3. hpack    64 MiB of HTTP header strings, RFC 7541 table: encode,
              indexed decode and foreign decode;
  4. chunked  64 MiB through HuffmanEncoder.encode_chunk and
              HuffmanDecoder.decode_chunk with 1 MiB capacities and feeds;
  5. mesh     MeshCodec on a 1-device mesh, 128 MiB: bytes == th.encode;
  6. tests    the ``gpu``-marked tests, in this process.

Each phase runs twice (cold: compiles included, then warm) and prints both
wall times and the paths ops/dispatch.py chose. The run fails with a
non-zero exit and prints no result when JAX finds no GPU, when a phase
takes any path but the compiled lane kernel, or when an output differs.
The last line of standard output is the JSON result. ``--rehearse`` runs
the phases at 1/256 of their sizes on whatever backend JAX has and never
prints a result (exit 3).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
MiB = 1 << 20
# ops whose path must be the compiled lane kernel
LANE_OPS = ("decode_indexed", "selfsync", "mesh_decode")


class PhaseError(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseError(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode:
        raise PhaseError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


def run_phase(name, body, needs, expect_impl):
    """Run ``body()`` cold and warm under dispatch.observe(); check every
    lane-decode choice and that each op in ``needs`` ran."""
    from tpu_huffman.ops import dispatch

    times = []
    for _ in range(2):
        with dispatch.observe() as seen:
            t0 = time.perf_counter()
            info = body()
            times.append(time.perf_counter() - t0)
        paths = sorted(set(seen))
        bad = [p for p in paths
               if (p[0] in LANE_OPS and p[1] != expect_impl)
               or p[1] == "sequential"]
        check(not bad, f"{name}: unexpected paths {bad}")
        missing = set(needs) - {op for op, _ in paths}
        check(not missing, f"{name}: never ran {sorted(missing)}")
    print(f"phase {name}: cold {times[0]:.3f} s, warm {times[1]:.3f} s, "
          f"paths {paths}, {info}", flush=True)


def phase_bulk(th, oracle, rng, n):
    table = th.load_static_test_table()
    data = rng.integers(0, 256, size=n, dtype="uint8")
    raw = data.tobytes()
    want = oracle.oracle_encode(raw, table)

    def body():
        enc = th.encode(data, table)
        check(enc == want, "bulk: th.encode != oracle")
        check(th.decode(enc, table) == raw, "bulk: th.decode != input")
        return f"{n} B -> {len(enc)} B ({8 * len(enc)} bits)"

    return body, ("selfsync",)


def phase_indexed(th, oracle, rng, n):
    table = th.load_static_test_table()
    raw = rng.integers(0, 256, size=n, dtype="uint8").tobytes()
    want = oracle.oracle_encode(raw, table)

    def body():
        enc, idx = th.encode_with_index(raw, table)
        check(enc == want, "indexed: encode_with_index != oracle")
        check(th.decode_indexed(enc, idx, table) == raw,
              "indexed: decode_indexed != input")
        return f"{n} B, {idx.bit_offsets.size} blocks of {idx.symbols_per_block}"

    return body, ("decode_indexed",)


def phase_hpack(th, oracle, rng, n):
    import numpy as np

    from tpu_huffman import corpora

    table = th.load_hpack_table()
    base = corpora.hpack_headers(min(n, 4 * MiB), seed=int(rng.integers(1 << 30)))
    raw = (base * (-(-n // len(base))))[:n]
    want = oracle.oracle_encode(raw, table)
    eff = int(table.lengths[np.frombuffer(raw, np.uint8)].max())

    def body():
        enc = th.encode(raw, table)
        check(enc == want, "hpack: th.encode != oracle")
        enc2, idx = th.encode_with_index(raw, table)
        check(enc2 == want, "hpack: encode_with_index != oracle")
        check(th.decode_indexed(enc2, idx, table) == raw,
              "hpack: decode_indexed != input")
        check(th.decode(enc, table) == raw, "hpack: th.decode != input")
        return f"{n} B -> {len(enc)} B, longest code {eff} bits"

    return body, ("decode_indexed", "selfsync")


def phase_chunked(th, oracle, rng, n, cap):
    table = th.load_static_test_table()
    raw = rng.integers(0, 256, size=n, dtype="uint8").tobytes()
    want = oracle.oracle_encode(raw, table)

    def body():
        enc = th.HuffmanEncoder(table)
        parts, pending, calls = [], raw, 0
        while True:
            r = enc.encode_chunk(pending, cap)
            parts.append(r.data)
            pending = pending[r.consumed:]
            calls += 1
            if r.done:
                break
        encoded = b"".join(parts)
        check(encoded == want, "chunked: encode_chunk stream != oracle")
        dec = th.HuffmanDecoder(table)
        out = []
        for i in range(0, len(encoded), cap):
            r = dec.decode_chunk(encoded[i:i + cap], capacity=cap)
            out.append(r.data)
            while not r.done:
                r = dec.decode_chunk(b"", capacity=cap)
                out.append(r.data)
        check(b"".join(out) == raw, "chunked: decode_chunk stream != input")
        return f"{n} B in {calls} encode calls, {len(out)} decode calls"

    return body, ("selfsync",)


def phase_mesh(th, oracle, rng, n, devices):
    from tpu_huffman.shard import MeshCodec, default_mesh

    table = th.load_static_test_table()
    raw = rng.integers(0, 256, size=n, dtype="uint8").tobytes()
    want = oracle.oracle_encode(raw, table)
    codec = MeshCodec(table, default_mesh(devices))

    def body():
        enc, idx = codec.encode(raw)
        check(enc == want, "mesh: MeshCodec.encode != oracle")
        check(enc == th.encode(raw, table), "mesh: MeshCodec.encode != th.encode")
        check(codec.decode(enc, idx) == raw, "mesh: MeshCodec.decode != input")
        return f"{n} B over {len(devices)} device(s)"

    return body, ("mesh_decode",)


def phase_tests():
    """The gpu-marked tests, in this process (one JAX process per card)."""
    import pytest

    class Count:
        def __init__(self):
            self.passed = self.failed = self.skipped = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                self.passed += 1
            elif report.failed:
                self.failed += 1
            elif report.skipped:
                self.skipped += 1

    os.environ["HUFFMAN_TEST_GPU"] = "1"
    count = Count()
    t0 = time.perf_counter()
    rc = pytest.main(
        ["-q", "-o", "addopts=", "-p", "no:xdist", "-p", "no:cacheprovider",
         "-m", "gpu", os.path.join(HERE, "tests")],
        plugins=[count],
    )
    check(rc == 0 and count.failed == 0 and count.skipped == 0
          and count.passed > 0,
          f"tests: rc {rc}, {count.passed} passed, {count.failed} failed, "
          f"{count.skipped} skipped")
    print(f"phase tests: {count.passed} passed in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: only MeshCodec over four cards on 512 MiB")
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny sizes on any backend; never prints a result")
    args = ap.parse_args()

    if not os.path.isdir(os.path.join(HERE, "tpu_huffman")):
        print("chip_smoke: run from a checkout (tpu_huffman/ is not beside "
              "this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from tpu_huffman import cache

    cache.enable()
    import jax
    import numpy as np

    platform = jax.default_backend()
    if platform != "gpu" and not args.rehearse:
        print(f"chip_smoke: no GPU (JAX backend {platform!r})", file=sys.stderr)
        return 1
    devices = jax.devices()
    if len(devices) < args.chips:
        print(f"chip_smoke: --chips {args.chips} but JAX sees {len(devices)} "
              "device(s)", file=sys.stderr)
        return 1

    import tpu_huffman as th
    from tpu_huffman import oracle
    from tpu_huffman.ops import dispatch

    scale = 256 if args.rehearse else 1
    expect = dispatch.lane_impl("chip_smoke")
    if not args.rehearse and expect != "triton":
        print(f"chip_smoke: dispatch chose {expect!r}, not the compiled "
              "kernel", file=sys.stderr)
        return 1
    print(f"jax {jax.__version__}, devices {devices}, lane decode {expect}",
          flush=True)
    rng = np.random.default_rng(args.seed)
    try:
        if args.chips == 4:
            phases = [("mesh4", phase_mesh(th, oracle, rng, 512 * MiB // scale,
                                           devices[:4]))]
        else:
            phases = [
                ("bulk", phase_bulk(th, oracle, rng, 1024 * MiB // scale)),
                ("indexed", phase_indexed(th, oracle, rng, 128 * MiB // scale)),
                ("hpack", phase_hpack(th, oracle, rng, 64 * MiB // scale)),
                # feeds stay above the streaming decoder's bulk threshold
                ("chunked", phase_chunked(th, oracle, rng, 64 * MiB // scale,
                                          MiB // min(scale, 8))),
                ("mesh", phase_mesh(th, oracle, rng, 128 * MiB // scale,
                                    devices[:1])),
            ]
        for name, (body, needs) in phases:
            run_phase(name, body, needs, expect)
        if args.chips == 1 and not args.rehearse:
            phase_tests()
        card = card_line() if platform == "gpu" else "no card (rehearsal)"
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"card: {card}", flush=True)
    if args.rehearse:
        print("chip_smoke: rehearsal passed; no device result", file=sys.stderr)
        return 3
    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
