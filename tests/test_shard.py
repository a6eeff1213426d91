"""Mesh data-parallel codec: the "fake pod" tier (SURVEY.md §4).

Runs on the conftest-forced 8-virtual-CPU-device backend. The contract:
MeshCodec output bytes are bit-identical to the single-device path (and
hence to the reference), on 1-D and 2-D meshes, at every shard split,
including ragged tails and empty shards.
"""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

import tpu_huffman as th
from tpu_huffman.shard import MeshCodec, default_mesh


@pytest.fixture(scope="module")
def table():
    return th.load_static_test_table()


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(42)
    return rng.integers(0, 256, size=50_000, dtype=np.uint8).tobytes()


def test_mesh_encode_bit_identical(table, corpus):
    mc = MeshCodec(table, default_mesh(), block_symbols=512)
    enc, idx = mc.encode(corpus)
    assert enc == th.encode(corpus, table)
    assert mc.decode(enc, idx) == corpus


def test_mesh_2d_dcn_ici(table, corpus, eight_devices):
    """2-D (hosts × devices) mesh: collectives across both axes."""
    devs = np.asarray(eight_devices).reshape(2, 4)
    mesh = Mesh(devs, ("process", "local"))
    mc = MeshCodec(table, mesh, block_symbols=512)
    enc, idx = mc.encode(corpus)
    assert enc == th.encode(corpus, table)
    assert mc.decode(enc, idx) == corpus


@pytest.mark.parametrize("n", [1, 7, 255, 4096, 12345])
def test_mesh_ragged_sizes(table, n):
    """Sizes that leave shards partially or fully empty."""
    rng = np.random.default_rng(n)
    data = rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
    mc = MeshCodec(table, default_mesh(), block_symbols=256)
    enc, idx = mc.encode(data)
    assert enc == th.encode(data, table)
    assert mc.decode(enc, idx) == data


def test_mesh_empty(table):
    mc = MeshCodec(table, default_mesh())
    enc, idx = mc.encode(b"")
    assert enc == b""
    assert mc.decode(enc, idx) == b""


def test_mesh_eos_padding(table):
    data = b"a"  # partial final byte guaranteed (5-10 bit code)
    for pad in (0x00, 0x5A, 0xFF):
        mc = MeshCodec(table, default_mesh(), block_symbols=256, eos_padding=pad)
        enc, _ = mc.encode(data)
        assert enc == th.encode(data, table, eos_padding=pad), hex(pad)


def test_mesh_unknown_symbol(table):
    sparse = th.make_canonical({65: 1, 66: 1}, name="ab")
    mc = MeshCodec(sparse, default_mesh(), block_symbols=256)
    with pytest.raises(th.UnknownSymbolError):
        mc.encode(b"ABC")


def test_global_offsets_past_2_31_bits(table, eight_devices):
    """The cross-shard offset math must not wrap at 2^31 bits.

    An int32 cumsum of shard bit totals wraps silently past ~256 MiB
    encoded; the exclusive prefix is computed in split (hi, lo) int32
    halves (shard._global_phase_base). Mock per-shard bit
    totals summing past 2^31 (no giant buffer needed) and check
    (phase, word_base) against int64 host arithmetic.
    """
    import functools

    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from tpu_huffman.shard import _global_phase_base

    mesh = default_mesh()
    ndev = 8
    rng = np.random.default_rng(7)
    # ~400 Mbit per shard with odd low bits: cumsum crosses 2^31 at shard 5.
    totals = (rng.integers(380_000_000, 430_000_000, size=ndev)).astype(
        np.int64
    ) | 1

    def body(lb):
        ph, wb = _global_phase_base(lb[0], axes=("data",))
        return jnp.stack([ph, wb])[None]

    fn = jax.jit(
        jax.shard_map(
            body, mesh=mesh, in_specs=(P("data"),), out_specs=P("data"),
            check_vma=False,
        )
    )
    out = np.asarray(fn(jnp.asarray(totals, dtype=jnp.int32))).reshape(ndev, 2)
    offs64 = np.cumsum(totals) - totals  # exclusive prefix, int64
    assert offs64[-1] > (1 << 31)  # the regression actually exercises wrap
    np.testing.assert_array_equal(out[:, 0], offs64 & 31)
    np.testing.assert_array_equal(out[:, 1], offs64 >> 5)


def test_block_index_offsets_are_int64(table, corpus):
    """Absolute block offsets are int64 end-to-end (single-device and
    mesh)."""
    _, idx1 = th.encode_with_index(corpus, table, block_symbols=512)
    assert idx1.bit_offsets.dtype == np.int64
    mc = MeshCodec(table, default_mesh(), block_symbols=512)
    _, idx2 = mc.encode(corpus)
    assert idx2.bit_offsets.dtype == np.int64
    np.testing.assert_array_equal(idx1.bit_offsets, idx2.bit_offsets)


def test_mesh_decode_passes_dispatch_choice(table, corpus, monkeypatch):
    """The mesh decode runs the lane decode chosen by ops/dispatch.py (the
    plain XLA version on the CPU) and an explicit impl overrides it."""
    from tpu_huffman.ops import dispatch, lanes

    seen = []
    orig = lanes.decode_lanes

    def spy(*a, **k):
        seen.append(k["impl"])
        return orig(*a, **k)

    monkeypatch.setattr(lanes, "decode_lanes", spy)
    mc = MeshCodec(table, default_mesh(), block_symbols=128)
    enc, idx = mc.encode(corpus[:5000])
    with dispatch.observe() as paths:
        assert mc.decode(enc, idx) == corpus[:5000]
    assert paths == [("mesh_decode", "xla")]
    assert mc.decode(enc, idx, impl="interpret") == corpus[:5000]
    assert seen == ["xla", "interpret"]


def test_mesh_decode_rejects_foreign_block_size(table, corpus):
    mc = MeshCodec(table, default_mesh(), block_symbols=128)
    enc, idx = th.encode_with_index(corpus[:3000], table, block_symbols=64)
    with pytest.raises(ValueError):
        mc.decode(enc, idx)


def test_mesh_decode_corrupt_stream_raises(table):
    data = bytes(range(256)) * 8
    mc = MeshCodec(table, default_mesh(), block_symbols=64)
    enc, idx = mc.encode(data)
    bad = bytearray(enc)
    bad[100:116] = bytes(16)  # 00000 is no prefix of the static table
    with pytest.raises(th.UnknownSymbolError):
        mc.decode(bytes(bad), idx)
