"""Thin observability: counters + profiler hook (SURVEY.md §5).

The reference has no logging/metrics at all; this build keeps this
deliberately thin: a process-local counter set and a context manager around
``jax.profiler.trace`` for XLA-level traces.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time


@dataclasses.dataclass
class Counters:
    encode_calls: int = 0
    decode_calls: int = 0
    bytes_in: int = 0
    bytes_out: int = 0
    blocks: int = 0
    encode_seconds: float = 0.0
    decode_seconds: float = 0.0

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)

    def reset(self) -> None:
        self.__dict__.update(Counters().__dict__)


_lock = threading.Lock()
counters = Counters()
enabled = False


def enable(flag: bool = True) -> None:
    """Turn call counting on/off (off by default: zero overhead)."""
    global enabled
    enabled = flag


@contextlib.contextmanager
def _count(kind: str, n_in: int):
    t0 = time.perf_counter()
    out_len = [0]
    yield out_len
    dt = time.perf_counter() - t0
    with _lock:
        if kind == "encode":
            counters.encode_calls += 1
            counters.encode_seconds += dt
        else:
            counters.decode_calls += 1
            counters.decode_seconds += dt
        counters.bytes_in += n_in
        counters.bytes_out += out_len[0]


def record(kind: str, n_in: int):
    """Used by the public wrappers when metrics are enabled."""
    if not enabled:
        return contextlib.nullcontext([0])
    return _count(kind, n_in)


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax.profiler trace of the enclosed codec work.

    View with TensorBoard or xprof. This is the tracing hook the reference
    lacks entirely (SURVEY.md §5 'Tracing / profiling: none').
    """
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
