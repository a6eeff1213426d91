"""Hand-written kernel vs the plain XLA version, end to end, on one GPU.

    python scripts/kernel_choices.py [--mb 128] [--reps 8] [--out FILE]

Measures what PERF.md "Kernel choices" records, all through the public
calls with the lane-decode implementation forced (``impl=``):

- indexed decode: ``th.decode_indexed`` with the Triton kernel vs the
  ``lax.scan`` version, over index block sizes;
- self-sync decode: ``selfsync.selfsync_decode`` (what ``th.decode`` runs
  for foreign streams) with either implementation;
- the lane kernel alone over tile sizes and warp counts;
- the XLA encode by stage: symbol-table gathers, length prefix sum, the two
  sorted scatter-adds, and the download of the words.

Host-clock wall times around calls that end in host bytes or
``block_until_ready``. Versions that are compared run interleaved in one
process (A B B A ...); each line gives the minimum and the median of
``--reps`` warm runs. "device" lines time the jitted device program alone
on device-resident inputs. Refuses to run without a GPU. Prints one JSON
line per measurement; ``--out`` also writes them all to one JSON file.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

MiB = 1 << 20


def best(fn, reps):
    return ab({"only": fn}, reps)["only"][0]


def ab(fns: dict, reps: int) -> dict:
    """Interleaved timing of several versions: rep r runs them in order,
    rep r+1 in reverse. Returns {name: (min, median)} seconds."""
    for fn in fns.values():
        fn()  # warm: compiles and caches
    names = list(fns)
    times = {k: [] for k in names}
    for r in range(reps):
        for k in names if r % 2 == 0 else names[::-1]:
            t0 = time.perf_counter()
            fns[k]()
            times[k].append(time.perf_counter() - t0)
    return {k: (min(v), float(np.median(v))) for k, v in times.items()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=int, default=128)
    ap.add_argument("--foreign-mb", type=int, default=64)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    from tpu_huffman import cache

    cache.enable()
    import jax
    import jax.numpy as jnp

    if jax.default_backend() != "gpu":
        sys.exit("no GPU")
    import tpu_huffman as th
    from tpu_huffman import oracle
    from tpu_huffman.ops import lanes, selfsync
    from tpu_huffman.ops.bitpack import stream_words_dev, words_from_u8_dev
    from tpu_huffman.ops.encode import DeviceTable

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    rows = []

    def emit(**kw):
        kw["card"] = card
        rows.append(kw)
        print(json.dumps(kw), flush=True)

    rng = np.random.default_rng(1)
    n = args.mb * MiB
    for tname, table in (("static", th.load_static_test_table()),
                         ("rfc7541", th.load_hpack_table())):
        if tname == "static":
            raw = rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
        else:
            from tpu_huffman import corpora

            base = corpora.hpack_headers(4 * MiB)
            raw = (base * (n // len(base) + 1))[:n]
        want = oracle.oracle_encode(raw, table)

        # (a) indexed decode, both implementations, over block sizes
        for K in (32, 64, 128, 256, 512):
            enc, idx = th.encode_with_index(raw, table, block_symbols=K)
            assert enc == want
            fns = {}
            for impl in ("triton", "xla"):
                assert th.decode_indexed(enc, idx, table, impl=impl) == raw
                fns[impl] = (lambda impl=impl:
                             th.decode_indexed(enc, idx, table, impl=impl))
            for impl, (tmin, tmed) in ab(fns, args.reps).items():
                emit(what="decode_indexed", table=tname, mb=args.mb, K=K,
                     impl=impl, seconds=tmin, median=tmed, gbps=n / tmin / 1e9)
            # the same decode's device program alone
            off = idx.bit_offsets
            lane_args = (stream_words_dev(enc), jnp.asarray(off >> 5),
                         jnp.asarray(off & 31), jnp.asarray(idx.n_symbols))
            lt = lanes.LaneTable.for_table(table)
            dev = {}
            for impl in ("triton", "xla"):
                f = jax.jit(lambda *a, impl=impl, K=K: lanes.decode_lanes(
                    *a, lt, steps=K, impl=impl)[0])
                dev[impl] = (lambda f=f: f(*lane_args).block_until_ready())
            for impl, (tmin, tmed) in ab(dev, args.reps).items():
                emit(what="decode_indexed_device", table=tname, mb=args.mb,
                     K=K, impl=impl, seconds=tmin, median=tmed,
                     gbps=n / tmin / 1e9)

            if K == 512:
                # where the public call's time goes, stage by stage
                from tpu_huffman.ops.decode import _decode_indexed_dev

                lane_in = np.zeros((3, lane_args[1].shape[0]), np.int32)
                lane_in[0], lane_in[1], lane_in[2] = off >> 5, off & 31, idx.n_symbols
                jl = jnp.asarray(lane_in)
                syms_dev, _bad = _decode_indexed_dev(
                    lane_args[0], jl, lt=lt, steps=K, impl="triton")
                stages = {
                    "upload_stream": lambda: stream_words_dev(enc).block_until_ready(),
                    "upload_index": lambda: jnp.asarray(lane_in).block_until_ready(),
                    "kernel": lambda: jax.block_until_ready(_decode_indexed_dev(
                        lane_args[0], jl, lt=lt, steps=K, impl="triton")),
                    "kernel_and_download": lambda: np.asarray(_decode_indexed_dev(
                        lane_args[0], jl, lt=lt, steps=K, impl="triton")[0]),
                    "to_bytes": lambda: np.asarray(syms_dev).reshape(-1)[:n].tobytes(),
                }
                for stage, fn in stages.items():
                    t = best(fn, args.reps)
                    emit(what="decode_indexed_stage", table=tname, mb=args.mb,
                         K=K, stage=stage, seconds=t)

        # (b) self-sync decode of the foreign stream
        nf = args.foreign_mb * MiB
        fenc = oracle.oracle_encode(raw[:nf], table)
        fns = {}
        for impl in ("triton", "xla"):
            assert selfsync.selfsync_decode(fenc, table, impl=impl) == raw[:nf]
            fns[impl] = (lambda impl=impl:
                         selfsync.selfsync_decode(fenc, table, impl=impl))
        for impl, (tmin, tmed) in ab(fns, args.reps).items():
            emit(what="selfsync_decode", table=tname, mb=args.foreign_mb,
                 impl=impl, seconds=tmin, median=tmed, gbps=nf / tmin / 1e9)
        # the self-sync device program alone (pass 0 + patch + merge +
        # repair + compaction), on the device-resident stream
        total_bits = len(fenc) * 8
        S, Bp, seg_bits, need_words = selfsync._plan_segments(
            total_bits, selfsync.SEG_WORDS)
        u8 = np.zeros(need_words * 4, np.uint8)
        u8[: len(fenc)] = np.frombuffer(fenc, np.uint8)
        jw = words_from_u8_dev(jnp.asarray(u8))
        max_syms = -(-((seg_bits + table.max_len) // table.min_len + 1) // 4) * 4
        lengths = jnp.asarray(table.lengths.astype(np.int32))
        dev = {}
        for impl in ("triton", "xla"):
            dev[impl] = (lambda impl=impl: jax.block_until_ready(
                selfsync._segments_pipeline_dense(
                    jw, jnp.int32(0), jnp.int32(0), lengths, jnp.int32(S),
                    need_words=need_words, Bp=Bp, seg_words=selfsync.SEG_WORDS,
                    max_syms=max_syms, lt=lanes.LaneTable.for_table(table),
                    impl=impl, n_dl=None)[:2]))
        for impl, (tmin, tmed) in ab(dev, args.reps).items():
            emit(what="selfsync_device", table=tname, mb=args.foreign_mb,
                 impl=impl, seconds=tmin, median=tmed, gbps=nf / tmin / 1e9)
        t = best(lambda: th.decode(fenc, table), args.reps)
        emit(what="th.decode", table=tname, mb=args.foreign_mb, seconds=t,
             gbps=nf / t / 1e9)

        # the lane kernel alone: tile and warp count
        enc, idx = th.encode_with_index(raw, table, block_symbols=512)
        words = stream_words_dev(enc)
        off = idx.bit_offsets
        lane_args = (words, jnp.asarray(off >> 5), jnp.asarray(off & 31),
                     jnp.asarray(idx.n_symbols))
        lt = lanes.LaneTable.for_table(table)
        for tile in (128, 256):
            for warps in (4, 8):
                lanes.TILE, lanes.NUM_WARPS = tile, warps
                fn = jax.jit(lambda *a, tile=tile, warps=warps: lanes.decode_lanes(
                    *a, lt, steps=512, impl="triton")[0])
                t = best(lambda: fn(*lane_args).block_until_ready(), args.reps)
                emit(what="lane_kernel", table=tname, K=512, tile=tile,
                     warps=warps, seconds=t, gbps=n / t / 1e9)
        lanes.TILE, lanes.NUM_WARPS = 128, 4

        # XLA encode by stage
        sym_np = np.frombuffer(raw, np.uint8)
        dt = DeviceTable.for_table(table)
        sym = jnp.asarray(sym_np)
        gather = jax.jit(lambda s: (dt.lengths[s], dt.patterns[s]))
        lens, pats = gather(sym)
        cums = jax.jit(lambda ln: jnp.cumsum(ln, dtype=jnp.int32))
        ends = cums(lens)

        @jax.jit
        def scatter(ends, lens, pats):
            starts = ends - lens
            p32 = jnp.where(lens > 0, pats << ((32 - lens.astype(jnp.uint32)) & 31), 0)
            widx = starts >> 5
            sh = (starts & 31).astype(jnp.uint32)
            hi = p32 >> sh
            lo = (p32 << (jnp.uint32(31) - sh)) << jnp.uint32(1)
            w = jnp.zeros(sym.shape[0] + 2, jnp.uint32)
            w = w.at[widx].add(hi, mode="drop", indices_are_sorted=True)
            return w.at[widx + 1].add(lo, mode="drop", indices_are_sorted=True)

        words_out = scatter(ends, lens, pats)
        nbytes = len(want)
        stages = {
            "upload": lambda: jnp.asarray(sym_np).block_until_ready(),
            "gather": lambda: jax.block_until_ready(gather(sym)),
            "cumsum": lambda: cums(lens).block_until_ready(),
            "scatter_adds": lambda: scatter(ends, lens, pats).block_until_ready(),
            "download": lambda: np.asarray(words_out[: -(-nbytes // 4)]),
            "th.encode": lambda: th.encode(raw, table),
        }
        for name, fn in stages.items():
            t = best(fn, args.reps)
            emit(what="encode_stage", table=tname, mb=args.mb, stage=name,
                 seconds=t, gbps=n / t / 1e9)

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
