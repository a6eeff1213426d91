"""Test configuration.

By default the suite runs on the CPU backend with 8 virtual devices (the
mesh tests need several), whatever accelerator the machine has. Set
HUFFMAN_TEST_GPU=1 to run on the machine's GPU instead; tests marked
``gpu`` need one and skip elsewhere. Card runs pass ``-p no:xdist``: one
JAX process per card.
"""

import os

import pytest

if not os.environ.get("HUFFMAN_TEST_GPU"):
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")

from tpu_huffman import cache  # noqa: E402

cache.enable()


@pytest.fixture(autouse=True)
def _needs_gpu(request):
    """Skip ``gpu``-marked tests unless JAX's default backend is a GPU
    (decided per test, never at import: every xdist worker must collect
    the same tests)."""
    if request.node.get_closest_marker("gpu") is not None:
        import jax

        if jax.default_backend() != "gpu":
            pytest.skip("needs an NVIDIA GPU: HUFFMAN_TEST_GPU=1 on the card")


@pytest.fixture
def eight_devices():
    """The 8-device CPU mesh (skips on a backend with fewer devices)."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices (the CPU tier's virtual mesh)")
    return jax.devices()[:8]
