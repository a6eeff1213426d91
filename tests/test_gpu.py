"""Card tests: the compiled lane kernel at full size on an NVIDIA GPU.

Marked ``gpu``: they skip anywhere JAX's default backend is not a GPU.
Run them on the card with

    HUFFMAN_TEST_GPU=1 python -m pytest -o addopts= -p no:xdist -m gpu tests/

(chip_smoke.py runs them in its last phase).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tpu_huffman as th
from tpu_huffman.ops import lanes, selfsync
from tpu_huffman.ops.bitpack import stream_words_dev

MiB = 1 << 20
pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def table():
    return th.load_static_test_table()


@pytest.fixture(scope="module")
def data64(table):
    rng = np.random.default_rng(64)
    raw = rng.integers(0, 256, size=64 * MiB, dtype=np.uint8).tobytes()
    return raw, th.encode_with_index(raw, table)


def test_kernel_matches_scan_at_64_mib(table, data64):
    """Count rule: the Triton kernel and the plain scan return the same
    arrays for every block of a 64 MiB indexed stream."""
    raw, (enc, idx) = data64
    words = stream_words_dev(enc)
    off = idx.bit_offsets
    args = (words, jnp.asarray(off >> 5), jnp.asarray(off & 31),
            jnp.asarray(idx.n_symbols))
    lt = lanes.LaneTable.for_table(table)
    outs = {}
    for impl in ("triton", "xla"):
        fn = jax.jit(lambda *a, impl=impl: lanes.decode_lanes(
            *a, lt, steps=idx.symbols_per_block, impl=impl)[:3])
        outs[impl] = [np.asarray(x) for x in fn(*args)]
    for a, b in zip(outs["triton"], outs["xla"]):
        np.testing.assert_array_equal(a, b)
    assert outs["triton"][0].reshape(-1)[: len(raw)].tobytes() == raw


def test_segment_kernel_matches_scan_at_64_mib(table, data64):
    """Limit rule with per-symbol offsets, as the self-sync pass 0 runs it."""
    _raw, (enc, _idx) = data64
    words = stream_words_dev(enc)
    seg_words = selfsync.SEG_WORDS
    S = len(enc) // (4 * seg_words) - 2
    base = jnp.arange(S, dtype=jnp.int32) * seg_words
    lt = lanes.LaneTable.for_table(table)
    max_syms = -(-((seg_words * 32 + table.max_len) // table.min_len + 1) // 4) * 4
    outs = {}
    for impl in ("triton", "xla"):
        fn = jax.jit(lambda w, b, impl=impl: lanes.decode_lanes(
            w, b, jnp.zeros_like(b), None, lt, steps=max_syms,
            limit=seg_words * 32, emit_offs=True, impl=impl))
        outs[impl] = [np.asarray(x) for x in fn(words, base)]
    for a, b in zip(outs["triton"], outs["xla"]):
        np.testing.assert_array_equal(a, b)


def test_gib_one_shot_round_trip(table):
    """1 GiB one-shot encode/decode, bit-exact, no caller chunking: both
    directions cross the 2^31-bit auto-segmentation."""
    from tpu_huffman import oracle

    rng = np.random.default_rng(42)
    big = rng.integers(0, 256, size=1 << 30, dtype=np.uint8)
    enc = th.encode(big, table)
    assert len(enc) * 8 > (1 << 31)  # genuinely past the int32 bound
    assert enc == oracle.oracle_encode(big.tobytes(), table)
    assert th.decode(enc, table) == big.tobytes()


def test_mesh_decode_gpu(table):
    """MeshCodec over every local card, compiled lane kernel per shard,
    equal to the plain scan body and to the single-card stream."""
    from tpu_huffman.shard import MeshCodec, default_mesh

    rng = np.random.default_rng(77)
    mc = MeshCodec(table, default_mesh())
    for n in (300_000, 32 * MiB + 1):
        raw = rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
        enc, idx = mc.encode(raw)
        assert enc == th.encode(raw, table)
        assert mc.decode(enc, idx) == raw
        assert mc.decode(enc, idx, impl="xla") == raw
