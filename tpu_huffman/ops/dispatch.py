"""The one place that chooses a device path.

Every decode entry point asks this module which implementation of the lane
decode (ops/lanes.py) to run, and whether an input is large enough for the
parallel paths. The choice depends only on ``jax.default_backend()`` and on
the input:

- ``gpu``: the lane decode is the Pallas kernel compiled through Triton;
- anything else (the CPU): the plain XLA version of the same loop.

Encode is plain XLA on every backend. The Pallas interpreter is never
chosen here: it exists only as the explicit ``impl="interpret"`` argument
that tests pass.

``observe()`` records the choices made inside a ``with`` block, so a caller
such as ``chip_smoke.py`` can check which path each phase took.
"""

from __future__ import annotations

import contextlib
import contextvars

import jax

# Foreign (un-indexed) streams longer than this decode through the parallel
# self-synchronizing path; shorter ones take the sequential scan, whose
# single dispatch is cheaper than the segment pipeline.
SELFSYNC_MIN_BYTES = 2048

_observer: contextvars.ContextVar[list | None] = contextvars.ContextVar(
    "tpu_huffman_dispatch_observer", default=None
)


def platform() -> str:
    """The default JAX backend: "gpu", "cpu", ..."""
    return jax.default_backend()


def lane_impl(op: str) -> str:
    """Implementation of the lane decode for ``op`` on the default backend:
    "triton" on an NVIDIA GPU, "xla" elsewhere."""
    impl = "triton" if platform() == "gpu" else "xla"
    note(op, impl)
    return impl


def note(op: str, path: str) -> None:
    """Record that ``op`` took ``path`` (a no-op outside ``observe()``)."""
    seen = _observer.get()
    if seen is not None:
        seen.append((op, path))


@contextlib.contextmanager
def observe():
    """Collect the (op, path) choices made inside the block."""
    seen: list[tuple[str, str]] = []
    token = _observer.set(seen)
    try:
        yield seen
    finally:
        _observer.reset(token)
