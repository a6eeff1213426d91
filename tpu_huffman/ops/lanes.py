"""Lane-parallel Huffman decode: many independent symbol chains, one stream.

Both parallel decodes reduce to one inner loop. Each lane starts at a known
bit position in a shared uint32 word stream (bitpack layout) and decodes
symbols one after the other; lanes never talk to each other. Two stop rules
select the decode:

- **count** (indexed decode, ``BlockIndex``): a lane is one index block and
  decodes exactly its symbol count;
- **limit** (self-synchronizing decode): a lane is one fixed-size segment
  and decodes every symbol that starts before the segment's bit limit.

Under either rule a window that matches no code steps the lane one bit and
poisons it: ``bad`` keeps 1 + the offset of the first such window and
``blast`` 1 + the offset of the last. ``emit_offs`` also returns the start
offset of every symbol slot (uint16, segment-relative).

A lane's position is a word index ``base`` plus a bit offset from the start
of that word, so streams past 2^31 bits stay addressable (word indices are
int32: 2^36 bits).

Three implementations return identical arrays:

- ``"triton"``: a Pallas kernel compiled through Triton for NVIDIA GPUs. One
  program decodes a tile of lanes; each lane keeps its offset in a register
  and loops over its symbols inside the kernel, reading stream words and
  the decode LUT with per-lane gathers. Symbols leave four per uint32.
- ``"interpret"``: the same kernel under the Pallas interpreter (tests).
- ``"xla"``: the same step as a ``lax.scan`` over symbols — the plain
  reference, and the CPU path.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ..tables import HuffmanTable

# Lanes per program (a power of two) and warps per program: one lane per
# thread measured fastest on the H100 (PERF.md "Kernel choices").
TILE = 128
NUM_WARPS = 4


class LaneTable:
    """A table's two-level decode LUT packed for the lane decode.

    Each int32 entry is ``(val << 8) | (bits & 0xFF)`` (tables.py layout:
    bits > 0 leaf, 0 invalid, < 0 pointer to a level-1 subtable), so a
    lookup is one gather per level. Hashable by content: it is a static
    argument of the jitted pipelines, and its arrays become constants.
    """

    def __init__(self, table: HuffmanTable):
        self.lut0 = self._pack(table.l0_bits, table.l0_val)
        self.lut1 = self._pack(table.l1_bits, table.l1_val)
        self.root_bits = int(table.root_bits)
        self.has_l1 = bool((table.l0_bits < 0).any())
        self._key = (self.root_bits, self.lut0.tobytes(), self.lut1.tobytes())
        self._hash = hash(self._key)

    @staticmethod
    def _pack(bits: np.ndarray, val: np.ndarray) -> np.ndarray:
        val = np.asarray(val, np.int64)
        if val.size and val.max() >= 1 << 23:
            raise ValueError("decode LUT too large for the packed lane layout")
        return ((val << 8) | (np.asarray(bits, np.int64) & 0xFF)).astype(np.int32)

    def __hash__(self) -> int:
        return self._hash

    def __eq__(self, other) -> bool:
        return isinstance(other, LaneTable) and self._key == other._key

    _cache: dict[int, tuple[HuffmanTable, "LaneTable"]] = {}

    @staticmethod
    def for_table(table: HuffmanTable) -> "LaneTable":
        hit = LaneTable._cache.get(id(table))
        if hit is None or hit[0] is not table:
            hit = (table, LaneTable(table))
            LaneTable._cache[id(table)] = hit
        return hit[1]


def _lookup(lut0, lut1, win, root_bits: int, has_l1: bool):
    """(symbol, bits_read) of 32-bit MSB-aligned windows; bits_read 0 = no
    code. ``lut0``/``lut1`` are arrays or kernel refs: both gather alike."""
    e = lut0[(win >> (32 - root_bits)).astype(jnp.int32)]
    if has_l1:
        b0 = (e << 24) >> 24
        is_ptr = b0 < 0
        width = jnp.where(is_ptr, -b0, 1).astype(jnp.uint32)
        sub = ((win << root_bits) >> ((jnp.uint32(32) - width) & jnp.uint32(31)))
        e = jnp.where(is_ptr, lut1[jnp.where(is_ptr, (e >> 8) + sub.astype(jnp.int32), 0)], e)
    return e >> 8, e & 0xFF


def _active(off, i, count, limit):
    act = None if count is None else i < count
    if limit is not None:
        act = off < limit if act is None else act & (off < limit)
    return act


def _step(words, lut0, lut1, base, off, active, bad, blast, *, root_bits,
          has_l1, wlast):
    """One symbol on every lane. Returns (sym, new_off, bad, blast)."""
    widx = jnp.minimum(base + (off >> 5), wlast)
    sh = (off & 31).astype(jnp.uint32)
    w0 = words[widx]
    w1 = words[widx + 1]
    # (w1 >> (32 - sh)) must be 0 at sh == 0: split the shift
    win = (w0 << sh) | ((w1 >> jnp.uint32(1)) >> (jnp.uint32(31) - sh))
    sym, ln = _lookup(lut0, lut1, win, root_bits, has_l1)
    invalid = active & (ln == 0)
    bad = jnp.where((bad == 0) & invalid, off + 1, bad)
    blast = jnp.where(invalid, off + 1, blast)
    off = off + jnp.where(active, jnp.where(invalid, 1, ln), 0)
    return jnp.where(active, sym, 0), off, bad, blast


def _scan(words, base, start, count, lut0, lut1, *, steps, limit, root_bits,
          has_l1):
    zero = jnp.zeros_like(base)

    def body(carry, i):
        off, bad, blast = carry
        active = _active(off, i, count, limit)
        sym, off2, bad, blast = _step(
            words, lut0, lut1, base, off, active, bad, blast,
            root_bits=root_bits, has_l1=has_l1, wlast=words.shape[0] - 2,
        )
        return (off2, bad, blast), (sym.astype(jnp.uint8), off.astype(jnp.uint16))

    (off, bad, blast), (syms, offs) = jax.lax.scan(
        body, (start, zero, zero), jnp.arange(steps, dtype=jnp.int32)
    )
    return syms.T, off, bad, offs.T, blast


def _kernel(*refs, steps4, limit, has_count, emit_offs, root_bits, has_l1,
            wlast):
    it = iter(refs)
    words_ref, base_ref, start_ref = next(it), next(it), next(it)
    count = next(it)[...] if has_count else None
    lut0_ref, lut1_ref = next(it), next(it)
    syms_ref, exit_ref, bad_ref = next(it), next(it), next(it)
    offs_ref, blast_ref = (next(it), next(it)) if emit_offs else (None, None)
    base = base_ref[...]
    zero = jnp.zeros_like(base)

    def body(j, carry):
        off, bad, blast = carry
        packed = jnp.zeros(base.shape, jnp.uint32)
        po = [packed, packed]
        for u in range(4):
            active = _active(off, 4 * j + u, count, limit)
            if emit_offs:
                po[u >> 1] = po[u >> 1] | (
                    (off.astype(jnp.uint32) & jnp.uint32(0xFFFF)) << (16 * (u & 1))
                )
            sym, off, bad, blast = _step(
                words_ref, lut0_ref, lut1_ref, base, off, active, bad, blast,
                root_bits=root_bits, has_l1=has_l1, wlast=wlast,
            )
            packed = packed | (sym.astype(jnp.uint32) << (8 * u))
        syms_ref[j, :] = packed
        if emit_offs:
            offs_ref[2 * j, :] = po[0]
            offs_ref[2 * j + 1, :] = po[1]
        return off, bad, blast

    off, bad, blast = jax.lax.fori_loop(
        0, steps4, body, (start_ref[...], zero, zero)
    )
    exit_ref[...] = off
    bad_ref[...] = bad
    if emit_offs:
        blast_ref[...] = blast


def _pallas(words, base, start, count, lut0, lut1, *, steps, limit,
            emit_offs, root_bits, has_l1, interpret):
    tile = TILE
    B = base.shape[0]
    Bp = -(-B // tile) * tile
    steps4 = -(-steps // 4)
    pad = Bp - B
    lanes = [base, start] + ([] if count is None else [count])
    lanes = [jnp.pad(a, (0, pad)) for a in lanes]

    def whole(a):
        return pl.BlockSpec(a.shape, lambda i: (0,) * a.ndim)

    def rows(r):
        # (slots, lanes): each slot row is stored coalesced across lanes
        return pl.BlockSpec((r, tile), lambda i: (0, i))

    lane = pl.BlockSpec((tile,), lambda i: (i,))
    out_specs = [rows(steps4), lane, lane]
    out_shape = [
        jax.ShapeDtypeStruct((steps4, Bp), jnp.uint32),
        jax.ShapeDtypeStruct((Bp,), jnp.int32),
        jax.ShapeDtypeStruct((Bp,), jnp.int32),
    ]
    if emit_offs:
        out_specs += [rows(2 * steps4), lane]
        out_shape += [
            jax.ShapeDtypeStruct((2 * steps4, Bp), jnp.uint32),
            jax.ShapeDtypeStruct((Bp,), jnp.int32),
        ]
    kernel = functools.partial(
        _kernel, steps4=steps4, limit=limit, has_count=count is not None,
        emit_offs=emit_offs, root_bits=root_bits, has_l1=has_l1,
        wlast=words.shape[0] - 2,
    )
    outs = pl.pallas_call(
        kernel,
        grid=(Bp // tile,),
        in_specs=[whole(words)] + [lane] * len(lanes) + [whole(lut0), whole(lut1)],
        out_specs=out_specs,
        out_shape=out_shape,
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="lane_decode",
    )(words, *lanes, lut0, lut1)

    def unpack(rows_u32, dtype, per_word):
        flat = jax.lax.bitcast_convert_type(rows_u32.T, dtype)
        return flat.reshape(Bp, per_word * rows_u32.shape[0])[:B, :steps]

    syms = unpack(outs[0], jnp.uint8, 4)
    exits, bad = outs[1][:B], outs[2][:B]
    if not emit_offs:
        return syms, exits, bad, None, None
    return syms, exits, bad, unpack(outs[3], jnp.uint16, 2), outs[4][:B]


def decode_lanes(words, base, start, count, lt: LaneTable, *, steps: int,
                 limit: int | None = None, emit_offs: bool = False,
                 impl: str):
    """Decode ``steps`` symbol slots on every lane (traceable).

    ``words``: uint32[W] stream words, W >= 2; reads past the end clamp to
    the last two words, so give real data one zero word of slack.
    ``base``/``start``: int32[B] word index and bit offset of each lane's
    first symbol. ``count``: int32[B] symbols per lane (count rule) or None.
    ``limit``: the static bit offset, relative to ``base``, at which a lane
    stops (limit rule) or None. At least one rule must be given; under the
    limit rule alone ``steps`` must be a multiple of 4.

    Returns (syms uint8[B, steps] — 0 in inactive slots, exits int32[B],
    bad int32[B], offs uint16[B, steps] or None, blast int32[B] or None).
    """
    if count is None and limit is None:
        raise ValueError("decode_lanes needs a count or a limit stop rule")
    if count is None and steps % 4:
        raise ValueError("limit-rule decodes need steps % 4 == 0")
    lut0 = jnp.asarray(lt.lut0)
    lut1 = jnp.asarray(lt.lut1)
    base = base.astype(jnp.int32)
    start = start.astype(jnp.int32)
    if count is not None:
        count = count.astype(jnp.int32)
    kw = dict(steps=steps, limit=limit, root_bits=lt.root_bits, has_l1=lt.has_l1)
    if impl == "xla":
        syms, exits, bad, offs, blast = _scan(
            words, base, start, count, lut0, lut1, **kw
        )
        return (syms, exits, bad) + ((offs, blast) if emit_offs else (None, None))
    if impl not in ("triton", "interpret"):
        raise ValueError(f"unknown lane decode implementation {impl!r}")
    return _pallas(
        words, base, start, count, lut0, lut1, emit_offs=emit_offs,
        interpret=impl == "interpret", **kw,
    )
