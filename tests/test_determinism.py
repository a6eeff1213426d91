"""Determinism tier (SURVEY.md §5: the JAX-path analog of race detection).

The reference's concurrency story is sanitizer CI on single-threaded code;
this build's analog is proving every parallel path is a pure function:
repeated runs and alternative kernels must produce byte-identical output.
"""

import numpy as np
import pytest

import tpu_huffman as th
from tpu_huffman.ops import selfsync
from tpu_huffman.shard import MeshCodec, default_mesh


@pytest.fixture(scope="module")
def table():
    return th.load_static_test_table()


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(99)
    return rng.integers(0, 256, size=30_000, dtype=np.uint8).tobytes()


def test_encode_is_deterministic(table, corpus):
    assert th.encode(corpus, table) == th.encode(corpus, table)


def test_all_decode_paths_agree(table, corpus):
    enc, idx = th.encode_with_index(corpus, table, block_symbols=16)
    # a max_output bound forces the sequential scan state machine
    sequential = th.decode(enc, table, max_output=len(corpus) + 8)
    indexed = th.decode_indexed(enc, idx, table, impl="interpret")
    selfsynced = selfsync.selfsync_decode(enc, table, seg_words=4,
                                          impl="interpret")
    assert sequential == indexed == selfsynced == th.decode(enc, table) == corpus


def test_selfsync_repeat_runs_identical(table, corpus):
    enc = th.encode(corpus, table)
    a = selfsync.selfsync_decode(enc, table, seg_words=4, impl="interpret")
    b = selfsync.selfsync_decode(enc, table, seg_words=4, impl="interpret")
    assert a == b == corpus


def test_mesh_vs_single_chip_identical(table, corpus):
    mc = MeshCodec(table, default_mesh(), block_symbols=256)
    enc_mesh, _ = mc.encode(corpus)
    assert enc_mesh == th.encode(corpus, table)
    enc_mesh2, _ = mc.encode(corpus)
    assert enc_mesh == enc_mesh2
