"""Bit-stream <-> word-array utilities shared by the encode/decode kernels.

The canonical on-device representation of a Huffman bit stream is an array of
uint32 words in MSB-first order: stream bit ``j`` lives in word ``j >> 5`` at
bit position ``31 - (j & 31)``. This replaces the reference's byte-at-a-time
working state (reference: source/huffman.c:50-55 encoder working byte,
source/huffman.c:82-83 decoder 64-bit window) with a layout that the VPU can
gather/shift in bulk. Everything here is 32-bit clean: no uint64, so kernels
run identically with JAX's default x64-disabled config.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def words_from_bytes_np(data: np.ndarray | bytes) -> tuple[np.ndarray, int]:
    """Pack bytes into big-endian uint32 words (host side). Returns (words, nbytes)."""
    b = np.frombuffer(bytes(data), dtype=np.uint8) if isinstance(data, (bytes, bytearray)) else np.asarray(data, dtype=np.uint8)
    nbytes = b.size
    pad = (-nbytes) % 4
    if pad:
        b = np.concatenate([b, np.zeros(pad, dtype=np.uint8)])
    words = b.reshape(-1, 4).astype(np.uint32)
    return (words[:, 0] << 24) | (words[:, 1] << 16) | (words[:, 2] << 8) | words[:, 3], nbytes


def bytes_from_words_np(words: np.ndarray, nbytes: int) -> bytes:
    """Unpack big-endian uint32 words into the first ``nbytes`` bytes (host side)."""
    w = np.asarray(words, dtype=np.uint32)
    out = np.empty((w.size, 4), dtype=np.uint8)
    out[:, 0] = (w >> 24) & 0xFF
    out[:, 1] = (w >> 16) & 0xFF
    out[:, 2] = (w >> 8) & 0xFF
    out[:, 3] = w & 0xFF
    return out.reshape(-1)[:nbytes].tobytes()


def words_to_bytes(words: jnp.ndarray) -> jnp.ndarray:
    """Device-side big-endian unpack: uint32[W] -> uint8[4W]."""
    w = words.astype(jnp.uint32)
    parts = jnp.stack(
        [(w >> 24) & 0xFF, (w >> 16) & 0xFF, (w >> 8) & 0xFF, w & 0xFF], axis=-1
    )
    return parts.reshape(*words.shape[:-1], -1).astype(jnp.uint8)


def bytes_to_words(b: jnp.ndarray) -> jnp.ndarray:
    """Device-side big-endian pack: uint8[4W] -> uint32[W] (length must be 4-aligned)."""
    v = b.astype(jnp.uint32).reshape(*b.shape[:-1], -1, 4)
    return (v[..., 0] << 24) | (v[..., 1] << 16) | (v[..., 2] << 8) | v[..., 3]


def extract_windows(words: jnp.ndarray, bit_offsets: jnp.ndarray) -> jnp.ndarray:
    """Gather 32-bit MSB-aligned windows starting at ``bit_offsets``.

    Equivalent of the reference decoder's working-bits refill + top-32 read
    (reference: source/huffman.c:196-211,236), vectorized: two word gathers
    plus shifts. ``words`` must have at least one zero pad word past the end
    of real data so windows near the tail read zeros (the reference behaves
    the same way: "there will be 0's in the bottom of working_bits",
    source/huffman.c:249-253).
    """
    idx = (bit_offsets >> 5).astype(jnp.int32)
    sh = (bit_offsets & 31).astype(jnp.uint32)
    w0 = words[idx]
    w1 = words[idx + 1]
    # (w1 >> (32 - sh)) with sh==0 must be 0; split the shift to stay defined.
    return (w0 << sh) | ((w1 >> 1) >> (31 - sh))


@jax.jit
def words_from_u8_dev(u8: jnp.ndarray) -> jnp.ndarray:
    """Device twin of :func:`words_from_bytes_np`: uint8[4W] -> uint32[W]
    (bit 0 = MSB of byte 0), a byte swap of the little-endian view."""
    x = jax.lax.bitcast_convert_type(u8.reshape(-1, 4), jnp.uint32).reshape(-1)
    return (
        ((x & jnp.uint32(0xFF)) << 24)
        | ((x & jnp.uint32(0xFF00)) << 8)
        | ((x >> 8) & jnp.uint32(0xFF00))
        | (x >> 24)
    )


def stream_words_dev(raw: bytes) -> jnp.ndarray:
    """Upload a byte stream as device words with at least two zero words of
    slack past the data, the word count bucketed (< 12.5% overshoot) so
    nearby sizes share compiled programs."""
    nw = -(-len(raw) // 4) + 2
    step = 1 << max(8, nw.bit_length() - 3)
    nw = -(-nw // step) * step
    u8 = np.zeros(4 * nw, np.uint8)
    u8[: len(raw)] = np.frombuffer(raw, np.uint8)
    return words_from_u8_dev(jnp.asarray(u8))
