"""ops/dispatch.py: the one place that chooses a device path."""

import numpy as np
import pytest

import tpu_huffman as th
from tpu_huffman.ops import dispatch


@pytest.mark.parametrize(
    "backend, impl",
    [("gpu", "triton"), ("cpu", "xla"), ("METAL", "xla"), ("rocm", "xla")],
)
def test_lane_impl_per_backend(monkeypatch, backend, impl):
    """The compiled kernel on a GPU, the plain XLA loop elsewhere — and
    never the Pallas interpreter at runtime."""
    monkeypatch.setattr(dispatch.jax, "default_backend", lambda: backend)
    assert dispatch.platform() == backend
    assert dispatch.lane_impl("decode_indexed") == impl != "interpret"


def test_observe_records_choices():
    with dispatch.observe() as seen:
        dispatch.note("op", "path")
        assert dispatch.lane_impl("x") == "xla"
    assert seen == [("op", "path"), ("x", "xla")]


def test_note_outside_observe_is_noop():
    dispatch.note("op", "path")  # no observer: nothing to record, no error
    with dispatch.observe() as outer:
        with dispatch.observe() as inner:
            dispatch.note("a", "b")
        dispatch.note("c", "d")
    assert inner == [("a", "b")] and outer == [("c", "d")]


def test_public_decodes_report_their_paths():
    t = th.load_static_test_table()
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, size=6000, dtype=np.uint8).tobytes()
    enc, idx = th.encode_with_index(data, t)
    with dispatch.observe() as seen:
        assert th.decode_indexed(enc, idx, t) == data
        assert th.decode(enc, t) == data
        assert th.decode(enc[:100], t, max_output=5) == data[:5]
    assert ("decode_indexed", "xla") in seen
    assert ("decode", "selfsync") in seen and ("selfsync", "xla") in seen
    assert ("decode", "sequential") in seen  # bounded output: the scan


def test_short_foreign_stream_takes_sequential():
    t = th.load_static_test_table()
    enc = th.encode(b"short stream", t)
    assert len(enc) <= dispatch.SELFSYNC_MIN_BYTES
    with dispatch.observe() as seen:
        assert th.decode(enc, t) == b"short stream"
    assert seen == [("decode", "sequential")]


def test_streaming_bulk_path_on_every_backend():
    """Big chunks take the device-resident self-sync path whatever the
    backend (it used to be gated to one accelerator)."""
    t = th.load_static_test_table()
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, size=80_000, dtype=np.uint8).tobytes()
    enc = th.encode(data, t)
    dec = th.HuffmanDecoder(t)
    with dispatch.observe() as seen:
        assert dec.decode_chunk(enc).data == data
    assert ("decode_chunk", "selfsync") in seen
