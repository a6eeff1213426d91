"""Self-synchronizing parallel decode of foreign (un-indexed) streams.

SURVEY.md §7 "Plan B": streams produced by other encoders (e.g. the
reference C library) carry no block index, so the serial bit-offset chain
must be broken another way. Prefix codes self-synchronize: a decode started
at a wrong bit offset converges to the true codeword-boundary chain after a
short prefix (the classic property exploited by GPU Huffman decoders).

Algorithm (one pass + patch, fixpoint as the fallback):
  1. Split the stream into fixed SEG_BITS-bit segments; segment s is one
     lane of the lane decode (ops/lanes.py, limit stop rule) reading the
     word stream from word ``s * seg_words``.
  2. Pass 0 decodes every segment from its aligned start, recording each
     symbol's start offset and the exit offset (first codeword start >=
     segment end). entry[s+1] <- exit[s] is then the TRUE entry of every
     segment whose predecessor synchronized.
  3. A short patch pass decodes PATCH_SYMS symbols from the true entries;
     the true chain is patch symbols up to the first boundary shared with
     pass 0, then pass 0's symbols. Merge, repair of the rare segments that
     do not merge, and compaction into one dense byte stream all run on
     device (``_dense_core``). The entry fixpoint (``_segments_pipeline``)
     remains the fallback that owns exact error positions.
  4. The final segment is finished by a host-side bit loop that applies the
     reference termination rules verbatim (need-more-input vs
     UNKNOWN_SYMBOL vs trailing padding, reference: source/huffman.c:240-255).

A lane that hits an invalid prefix mid-stream advances one bit and raises a
poison flag; if the flag survives on the *converged* chain (>= 32 bits from
stream end), the stream genuinely contains an unknown symbol and
UnknownSymbolError is raised — matching the reference's error condition.

Every pipeline takes ``impl``, the lane-decode implementation: None asks
ops/dispatch.py; tests pass "interpret" to run the Pallas kernel.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..errors import UnknownSymbolError
from ..tables import HuffmanTable
from . import dispatch, lanes
from .bitpack import words_from_u8_dev
from .lanes import LaneTable

SEG_WORDS = 32                  # 1024 bits per segment
SEG_BITS = SEG_WORDS * 32
SEG_SLACK = 2                   # neighbor words so straddling codes resolve


def _seg_decode(jwords, bases, entries, lt, *, steps, seg_words, impl,
                emit_offs=False):
    """Decode ``steps`` symbol slots of every segment lane (limit rule at the
    segment end). Returns lanes.decode_lanes' tuple."""
    return lanes.decode_lanes(
        jwords, bases, entries, None, lt, steps=steps, limit=seg_words * 32,
        emit_offs=emit_offs, impl=impl,
    )


def _selfsync_passes(jwords, S, Bp, max_syms, passes, lt, impl,
                     seg_words=SEG_WORDS, entry0=0):
    """Fixpoint iterations fully on device, dynamic pass count.

    A `lax.while_loop` drives the lane decode until the entry offsets stop
    changing or `passes` iterations elapse — ONE compile regardless of how
    many passes a stream needs (self-sync usually converges in 2-3).
    Padding lanes (>= S) decode garbage harmlessly: their entries never
    feed a real segment. Returns (syms u8[Bp, max_syms], exits, bad,
    converged_flag, entries).
    """
    seg_idx = jnp.arange(Bp, dtype=jnp.int32)
    bases = seg_idx * seg_words
    e0 = jnp.int32(entry0)
    entries0 = jnp.where(seg_idx == 0, e0, 0)  # pass 0: segment-aligned starts

    def one_pass(entries):
        syms, exits, bad, _o, _b = _seg_decode(
            jwords, bases, entries, lt, steps=max_syms, seg_words=seg_words,
            impl=impl,
        )
        # entry[s+1] = exit[s] - seg_bits (exit is relative to segment s;
        # segment s+1 starts seg_bits later).
        new = jnp.concatenate([e0[None], exits[:-1] - seg_words * 32])
        # only real segments matter; keep padding entries at 0
        new = jnp.where(seg_idx < S, new, 0)
        return new, syms, exits, bad

    def cond(carry):
        i, converged, *_ = carry
        return (~converged) & (i < passes)

    def body(carry):
        i, _, entries, _, _, _ = carry
        new, syms, exits, bad = one_pass(entries)
        converged = jnp.all(new == entries)
        return (i + 1, converged, new, syms, exits, bad)

    init = (
        jnp.int32(0),
        jnp.bool_(False),
        entries0,
        jnp.zeros((Bp, max_syms), jnp.uint8),
        jnp.zeros(Bp, jnp.int32),
        jnp.zeros(Bp, jnp.int32),
    )
    _, converged, entries, syms, exits, bad = jax.lax.while_loop(cond, body, init)
    return syms, exits, bad, converged, entries


def _decode_tail_host(table, stream_bits_value, nbits, max_syms=None):
    """Decode the final partial segment with exact reference termination.

    stream_bits_value: int holding the remaining bits MSB-first; nbits: its
    length. Mirrors source/huffman.c:230-281 for the tail of a one-shot call.
    ``max_syms`` stops after that many symbols WITHOUT inspecting the next
    window (the reference's output-full check runs before consuming,
    huffman.c:257-268 — but note UNKNOWN/padding checks come first, which
    :func:`_next_state` evaluates for the capped caller).
    Returns (symbols bytearray, pos) or raises UnknownSymbolError.
    """
    out = bytearray()
    pos = 0
    while True:
        if max_syms is not None and len(out) >= max_syms:
            return out, pos
        left = nbits - pos
        if left <= 0:
            return out, pos
        frag = stream_bits_value & ((1 << left) - 1)  # bits from pos onward
        if left >= 32:
            window = frag >> (left - 32)
        else:
            window = (frag << (32 - left)) & 0xFFFFFFFF
        sym, bits_read = table.decode_window(window)
        if bits_read == 0:
            if left < 32:
                return out, pos  # need more input / done (huffman.c:240-244)
            raise UnknownSymbolError()  # huffman.c:246
        if bits_read > left:
            return out, pos  # trailing padding / partial code (huffman.c:248-255)
        out.append(sym)
        pos += bits_read


def _next_state(table, stream_bits_value, nbits, pos) -> str:
    """Reference check order at one window (source/huffman.c:240-255):
    'unknown' (no match, >= 32 bits left), 'done' (no match with < 32 left,
    input exhausted, or code overruns the remaining bits = trailing
    padding), or 'more' (a further symbol is decodable)."""
    left = nbits - pos
    if left <= 0:
        return "done"
    frag = stream_bits_value & ((1 << left) - 1)
    window = (frag >> (left - 32)) if left >= 32 else (frag << (32 - left)) & 0xFFFFFFFF
    _sym, bits_read = table.decode_window(window)
    if bits_read == 0:
        return "unknown" if left >= 32 else "done"
    return "more" if bits_read <= left else "done"


def supports(table: HuffmanTable) -> bool:
    """Any prefix-free table qualifies; codes must fit the segment slack
    window (always true: MAX_CODE_BITS=32 <= 64)."""
    return int(table.lengths.max()) > 0 and table.max_len <= SEG_SLACK * 32


def selfsync_decode(data: bytes | np.ndarray, table: HuffmanTable,
                    seg_words: int = SEG_WORDS, impl: str | None = None) -> bytes:
    """Parallel decode of a foreign stream; bit-exact with the reference."""
    return selfsync_decode_ex(data, table, seg_words, impl=impl)[0]


def selfsync_decode_ex(
    data: bytes | np.ndarray,
    table: HuffmanTable,
    seg_words: int = SEG_WORDS,
    start_bit: int = 0,
    impl: str | None = None,
) -> tuple[bytes, int]:
    """Parallel decode returning (symbols, end_bit).

    ``end_bit`` is the absolute bit offset where decoding stopped: the start
    of the first code that does not complete within the input (mid-stream
    chunking) or the start of trailing padding (stream end) — exactly the
    resume point the reference decoder's window state encodes. ``start_bit``
    (< 8) lets a streaming caller resume mid-byte.

    Caller should check :func:`supports`. Falls back internally to more
    fixpoint passes if self-synchronization is slow; worst case degrades to
    S passes (pathological streams), still correct.
    """
    raw = bytes(data) if isinstance(data, (bytes, bytearray)) else np.asarray(
        data, dtype=np.uint8
    ).tobytes()
    seg = _selfsync_segments(raw, table, seg_words, start_bit, dense=True,
                             impl=impl)
    if seg is None:  # small stream (or non-convergence): pure host loop
        total_bits = len(raw) * 8
        if not raw or total_bits <= start_bit:
            return b"", start_bit
        value = int.from_bytes(raw, "big") & ((1 << (total_bits - start_bit)) - 1)
        out, pos = _decode_tail_host(table, value, total_bits - start_bit)
        return bytes(out), start_bit + pos

    if isinstance(seg[0], str):
        _tag, body_bytes, tail_start_bit = seg
    else:
        syms, starts, counts, bad_np, S, seg_bits, tail_start_bit = seg
        # Unknown symbol on the converged chain? Reference raises only with
        # >= 32 bits left (huffman.c:246); all these segments are mid-stream.
        if (bad_np != 0).any():
            raise UnknownSymbolError()
        mask = np.arange(syms.shape[1])[None, :] < counts[:, None]
        body_bytes = syms[mask].tobytes()

    # Tail: everything from the last full segment's exit onward (read only
    # the tail bytes — a whole-stream bigint is slow on the host).
    total_bits = len(raw) * 8
    left = total_bits - tail_start_bit
    tail_value = int.from_bytes(raw[tail_start_bit >> 3 :], "big") & (
        (1 << left) - 1
    )
    tail, pos = _decode_tail_host(table, tail_value, left)
    return body_bytes + bytes(tail), tail_start_bit + pos


def _plan_segments(total_bits: int, seg_words: int):
    """Segment plan for a stream view of ``total_bits`` bits.

    Returns (S, Bp, seg_bits, need_words) or None when the stream is too
    small for the lane path (caller should host-loop).
    """
    seg_bits = seg_words * 32
    if total_bits <= 0:
        return None
    # Small streams: the host bit loop is cheaper than a launch.
    if total_bits <= 4 * seg_bits:
        return None
    # Full segments exclude the stream tail: the last (possibly partial)
    # segment plus one guard segment are finished on host with exact
    # termination rules.
    S_total = -(-total_bits // seg_bits)
    S = S_total - 1 if total_bits % seg_bits else S_total
    S -= 1  # guard segment before the tail
    if S <= 0:
        return None
    # Bucket the lane count to powers of two so chunked callers with
    # varying stream sizes reuse one compiled pipeline per bucket (S is
    # traced; padding lanes decode garbage harmlessly).
    Bp = max(16, 1 << (S - 1).bit_length())
    need_words = Bp * seg_words + seg_words  # one extra segment >= slack
    return S, Bp, seg_bits, need_words


def _selfsync_segments(raw: bytes, table: HuffmanTable, seg_words: int,
                       start_bit: int, dense: bool = False,
                       impl: str | None = None):
    """Run the segment pipelines over the stream's full segments.

    Returns None when the stream is too small for the lane path (caller
    should host-loop), else (syms u8[S, max_syms], starts i64[S, max_syms]
    — SEGMENT-RELATIVE bit start of each emitted symbol, counts i32[S],
    bad i32[S] (0 = clean, else 1 + segment-relative bit of the first
    invalid window; symbols of that segment are valid only before that
    bit), S, seg_bits, tail_start_bit — absolute resume point for the host
    tail decode).
    """
    if not 0 <= start_bit < 8:
        raise ValueError("start_bit must be in [0, 8)")
    if not raw or len(raw) * 8 <= start_bit:
        return None
    total_bits = len(raw) * 8
    plan = _plan_segments(total_bits, seg_words)
    if plan is None:
        return None
    S, Bp, seg_bits, need_words = plan
    # Stage the raw bytes and byteswap on device (the host big-endian
    # conversion is a full extra pass over the stream).
    nb_need = min(len(raw), need_words * 4)
    pad8 = np.zeros(need_words * 4, np.uint8)
    pad8[:nb_need] = np.frombuffer(raw, np.uint8, nb_need)
    return _segments_from_words(
        words_from_u8_dev(jnp.asarray(pad8)), table, seg_words, start_bit,
        S, Bp, seg_bits, dense=dense, impl=impl,
    )


def _segments_from_words(jwords, table: HuffmanTable, seg_words: int,
                         start_bit: int, S: int, Bp: int,
                         seg_bits: int, w0: int = 0,
                         need_words: int | None = None,
                         dense: bool = False, impl: str | None = None):
    """Lane passes + host post-processing over pre-planned segments.

    ``jwords``: device uint32 words of the stream view (bit 0 = MSB of word
    0), zero-padded to the plan's need_words. ``start_bit`` may be any
    value < 32 (device-resident callers resume mid-word). Return contract
    matches :func:`_selfsync_segments` — except with ``dense=True``, where
    the happy path returns ("dense", body_bytes, tail_start_bit) instead:
    the merge-stitch AND the compaction run on device, so only the decoded
    bytes cross to the host. Callers that need per-symbol starts (the
    capped protocol) keep dense=False.
    """
    lt = LaneTable.for_table(table)
    impl = impl or dispatch.lane_impl("selfsync")
    if not 0 <= start_bit < 32:
        raise ValueError("start_bit must be in [0, 32)")
    min_len = max(int(table.min_len), 1)
    max_syms = (seg_bits + table.max_len) // min_len + 1
    max_syms = -(-max_syms // 4) * 4

    if need_words is None:
        need_words = int(jwords.shape[0]) - w0
    if jwords.shape[0] < w0 + need_words:
        jwords = jnp.pad(jwords, (0, w0 + need_words - jwords.shape[0]))
    pipe_kw = dict(need_words=need_words, Bp=Bp, seg_words=seg_words,
                   max_syms=max_syms, lt=lt, impl=impl)

    if dense:
        full_grid = Bp * (max_syms + PATCH_SYMS)
        rate = getattr(table, "_dec_rate_hint", None)
        n_dl = (
            _dl_bucket(rate * S * seg_bits, full_grid)
            if rate is not None else full_grid
        )
        lengths = jnp.asarray(table.lengths.astype(np.int32))
        body_pad, small, raw = _segments_pipeline_dense(
            jwords, jnp.int32(w0), jnp.int32(start_bit), lengths,
            jnp.int32(S), n_dl=n_dl, **pipe_kw,
        )
        (total, all_ok, last_exit, counts_d, resolved_d, e1_d, exits0_d,
         dl_over) = jax.device_get(small)
        tail_start_bit = S * seg_bits + int(last_exit) - seg_bits
        n_body = int(total)
        if bool(dl_over):
            # body outgrew the rate-hint slot grid: refresh the hint and
            # re-run once with the worst-case grid (rare; data shifted)
            _learn_dl_rate(table, n_body, S * seg_bits)
            body_pad, small, raw = _segments_pipeline_dense(
                jwords, jnp.int32(w0), jnp.int32(start_bit), lengths,
                jnp.int32(S), n_dl=full_grid, **pipe_kw,
            )
            (total, all_ok, last_exit, counts_d, resolved_d, e1_d,
             exits0_d, _over2) = jax.device_get(small)
            tail_start_bit = S * seg_bits + int(last_exit) - seg_bits
            n_body = int(total)
        if bool(all_ok):
            _learn_dl_rate(table, n_body, S * seg_bits)
            body = np.asarray(body_pad[:n_body]).tobytes()
            return ("dense", body, tail_start_bit)
        # Repair + splice: re-decode the failed segments from their true
        # entries (same validation as _stitch_fast), then replace their
        # byte ranges in the dense download. Counts may change, so the
        # splice rebuilds from O(failures) slices.
        resolved = resolved_d[:S]
        idx = np.flatnonzero(~resolved)
        if idx.size <= max(64, S >> 5):
            counts = counts_d[:S].astype(np.int64)
            e1_h = e1_d[:S]
            exits0_h = exits0_d[:S].astype(np.int64)
            rep_syms, rep_exits, rep_bad = _dense_repair(
                jwords, w0, idx, e1_h[idx].astype(np.int32), seg_words,
                max_syms, lt, impl,
            )
            if (
                (rep_bad == 0).all()
                and (rep_exits.astype(np.int64) == exits0_h[idx]).all()
            ):
                lens_r = table.lengths[rep_syms].astype(np.int64)
                starts_r = (
                    np.cumsum(lens_r, axis=1) - lens_r
                    + e1_h[idx].astype(np.int64)[:, None]
                )
                counts_r = (starts_r < seg_bits).sum(axis=1)
                body_np = np.asarray(body_pad[:n_body])
                pos = np.concatenate([[0], np.cumsum(counts)])
                pieces = []
                prev = 0
                for k, s in enumerate(idx):
                    pieces.append(body_np[prev:pos[s]])
                    pieces.append(rep_syms[k, : counts_r[k]])
                    prev = pos[s + 1]
                pieces.append(body_np[prev:n_body])
                return (
                    "dense",
                    np.concatenate(pieces).tobytes(),
                    tail_start_bit,
                )
        # corrupt stream / unsynced chain / too many failures: classic path
        fast = jax.device_get(raw)
    else:
        # Fast path: one full pass + patch pass; host merge-stitch. Falls
        # back to the fixpoint loop when a segment doesn't resolve
        # (pathological self-sync or a poisoned chain, where exact bad-bit
        # semantics matter).
        fast = jax.device_get(_segments_pipeline_fast(
            jwords, jnp.int32(w0), jnp.int32(start_bit), jnp.int32(S),
            **pipe_kw,
        ))

    def repair_fn(idx: np.ndarray, entries_r: np.ndarray):
        return _dense_repair(
            jwords, w0, idx, entries_r, seg_words, max_syms, lt, impl,
        )

    stitched = _stitch_fast(
        table, fast, S, seg_bits, max_syms, repair_fn
    )
    if stitched is not None:
        return stitched

    outs = _segments_pipeline(
        jwords, jnp.int32(w0), jnp.int32(start_bit), S=S, **pipe_kw,
    )
    syms, entries_np, exits_np, bad_np, converged = jax.device_get(outs)
    if not bool(converged):  # can't happen within S+1 passes, but be safe
        return None
    entries_np = entries_np[:S]
    exits_np = exits_np[:S]
    bad_np = bad_np[:S]
    syms = np.asarray(syms)[:S]
    # Per-symbol bit starts: entry + exclusive cumsum of code lengths. The
    # active steps emitted exactly the symbols whose start < SEG_BITS, so
    # the count per segment is one comparison-reduction away. (For a
    # poisoned segment this is valid only before the bad bit — the capped
    # caller accounts for that; selfsync_decode_ex raises first.)
    lens_of = table.lengths[syms]  # [S, max_syms] code length per emitted sym
    starts = (
        np.cumsum(lens_of, axis=1, dtype=np.int64)
        - lens_of
        + entries_np[:, None]
    )
    counts = (starts < seg_bits).sum(axis=1).astype(np.int64)

    tail_start_bit = S * seg_bits + int(exits_np[-1]) - seg_bits
    return syms, starts, counts, bad_np, S, seg_bits, tail_start_bit


@functools.partial(jax.jit, static_argnames=("size",))
def _dslice(buf, start, size):
    return jax.lax.dynamic_slice(buf, (start,), (size,))


def _dense_repair(jwords, w0, idx: np.ndarray, entries_r: np.ndarray,
                  seg_words: int, max_syms: int, lt, impl):
    """Compacted device re-decode of failed segments.

    One lane per failed segment, reading the (device) word stream at the
    segment's own base; returns (syms u8[R, max_syms], exits i32[R],
    bad i32[R]). Cost scales with the failure count, not the stream.
    """
    R = idx.size
    Rp = max(16, 1 << (R - 1).bit_length())
    bases = np.zeros(Rp, np.int64)
    bases[:R] = w0 + idx.astype(np.int64) * seg_words
    ent = np.zeros(Rp, np.int32)
    ent[:R] = entries_r
    syms, exits, bad = _repair_call(
        jwords, jnp.asarray(bases.astype(np.int32)), jnp.asarray(ent),
        lt=lt, max_syms=max_syms, seg_words=seg_words, impl=impl,
    )
    syms_r, exits_np, bad_np = jax.device_get((syms, exits, bad))
    return np.asarray(syms_r)[:R], exits_np[:R], bad_np[:R]


@functools.partial(
    jax.jit, static_argnames=("lt", "max_syms", "seg_words", "impl")
)
def _repair_call(jwords, bases, entries, *, lt, max_syms, seg_words, impl):
    return _seg_decode(
        jwords, bases, entries, lt, steps=max_syms, seg_words=seg_words,
        impl=impl,
    )[:3]


def _stitch_fast(table, fast, S, seg_bits, max_syms, repair_fn):
    """Merge-stitch the (full pass, patch pass) outputs on host.

    Per segment the TRUE symbol chain is: patch symbols from the true
    entry up to the first boundary shared with the full pass's chain,
    then the full pass's symbols from that boundary on (self-sync: the
    chains coincide once they share a boundary — prefix codes decode
    deterministically forward). Segments that fail to resolve (sync
    slower than the patch reach) are re-decoded from their true entries
    by ``repair_fn`` — a compacted device round over just those segments
    — and validated against pass 0's exits. Only a corrupt stream, an
    unsynced pass-0 chain, or too many failures return None (the caller
    then runs the fixpoint loop, which owns exact error semantics).
    Returns the `_selfsync_segments` tuple or None.
    """
    syms0, symsA, offs0, exits0, exitsA, blast0, badA, entries1 = fast
    A = PATCH_SYMS
    syms0 = np.asarray(syms0)[:S]
    symsA = np.asarray(symsA)[:S]
    exits0 = exits0[:S].astype(np.int64)
    exitsA = exitsA[:S].astype(np.int64)
    blast0 = blast0[:S].astype(np.int64)
    badA = badA[:S]
    e1 = entries1[:S].astype(np.int64)

    # EXACT pass-0 chain boundaries from the lane decode: host cumsum of
    # symbol lengths would diverge at invalid 1-bit steps, which
    # Kraft-incomplete tables (like the reference's static test table,
    # Kraft sum 0.76) hit routinely on wrong-offset prefixes.
    starts0 = np.asarray(offs0)[:S].astype(np.int64)
    count0 = (starts0 < seg_bits).sum(axis=1)
    lensA = table.lengths[symsA].astype(np.int64)
    pA = np.cumsum(lensA, axis=1) - lensA + e1[:, None]
    countA = (pA < seg_bits).sum(axis=1)

    # First patch boundary that is also a pass-0 boundary (per segment).
    # Row-keyed flat searchsorted: starts0 rows are sorted (lengths are
    # positive), BIG exceeds any in-segment bit offset.
    BIG = np.int64(1) << 22
    rows_key = np.arange(S, dtype=np.int64)[:, None]
    key0 = (starts0 + rows_key * BIG).ravel()
    qA = pA + rows_key * BIG
    pos = np.searchsorted(key0, qA.ravel()).reshape(S, A)
    val = key0[np.clip(pos, 0, key0.size - 1)]
    hit = val == qA
    j_of = pos % max_syms
    row_of = pos // max_syms
    hit &= (
        (row_of == np.arange(S)[:, None])
        & (j_of < count0[:, None])
        & (np.arange(A)[None, :] < countA[:, None])
    )
    any_hit = hit.any(axis=1)
    i_s = np.where(any_hit, hit.argmax(axis=1), 0)
    j_s = np.where(any_hit, j_of[np.arange(S), i_s], 0)

    # Resolution: merged in-segment (with pass 0's LAST invalid window
    # strictly before the merge point — from the merge on, the pass-0
    # chain is the true chain), or the patch covered the whole segment
    # with an exit matching pass 0's (segment s+1's entry was built from
    # the latter). Unresolved segments get the repair round below.
    reached_end = countA < A
    merge_bit = np.where(any_hit, pA[np.arange(S), i_s], 0)
    tail_clean = (blast0 == 0) | (blast0 - 1 < merge_bit)
    use_tail = any_hit & tail_clean
    resolved = (badA == 0) & (use_tail | (reached_end & (exitsA == exits0)))
    n_failed = int(S - resolved.sum())
    if n_failed > max(64, S >> 5):
        return None  # too much repair work: the fixpoint pass is cheaper

    i_eff = np.where(use_tail, i_s, countA)
    head_mask = np.arange(A)[None, :] < i_eff[:, None]
    cols0 = np.arange(max_syms)[None, :]
    tail_mask = (
        (cols0 >= j_s[:, None]) & (cols0 < count0[:, None]) & use_tail[:, None]
    )
    comb_syms = np.concatenate([symsA, syms0], axis=1)
    comb_starts = np.concatenate([pA, starts0], axis=1)
    comb_mask = np.concatenate([head_mask, tail_mask], axis=1)
    counts = i_eff + np.where(use_tail, count0 - j_s, 0)

    W = max_syms + A
    syms = np.zeros((S, W), np.uint8)
    starts = np.full((S, W), np.int64(seg_bits) + BIG, np.int64)
    rr, cc = np.nonzero(comb_mask)
    rowpos = np.cumsum(comb_mask, axis=1) - 1
    syms[rr, rowpos[rr, cc]] = comb_syms[rr, cc]
    starts[rr, rowpos[rr, cc]] = comb_starts[rr, cc]

    # Repair round: re-decode the failed segments — compacted, on device —
    # from their true entries (e1, which every segment inherits from pass
    # 0's exits regardless of patch success). The repair validates each
    # repaired exit against pass 0's: equality proves pass 0's chain was
    # synced by segment end, so downstream entries (and resolved rows)
    # were built on true boundaries. A mismatch, or an invalid window on
    # a repaired (true) chain, falls back to the fixpoint.
    if n_failed:
        idx = np.flatnonzero(~resolved)
        rep = repair_fn(idx, e1[idx].astype(np.int32))
        rep_syms, rep_exits, rep_bad = rep
        if (rep_bad != 0).any():
            return None  # corrupt stream: fixpoint owns exact error bits
        if not (rep_exits.astype(np.int64) == exits0[idx]).all():
            return None  # pass-0 chain not synced by segment end
        lens_r = table.lengths[rep_syms].astype(np.int64)
        starts_r = (
            np.cumsum(lens_r, axis=1) - lens_r + e1[idx][:, None]
        )
        counts_r = (starts_r < seg_bits).sum(axis=1)
        m = rep_syms.shape[1]
        syms[idx, :] = 0
        syms[idx, :m] = rep_syms
        starts[idx, :] = np.int64(seg_bits) + BIG
        starts[idx, :m] = starts_r
        counts[idx] = counts_r

    tail_start_bit = S * seg_bits + int(exits0[-1]) - seg_bits
    bad_ret = np.zeros(S, np.int32)
    return syms, starts, counts, bad_ret, S, seg_bits, tail_start_bit


# Patch-pass symbol slots: after one full pass, every segment's TRUE entry
# offset is known (exit of its predecessor); the patch decodes only the
# short head from that entry until it merges into the full pass's chain.
# Self-sync distance on the Kraft-incomplete static table is ~100-250 bits
# (invalid windows step 1 bit), so 32 slots (>=160 bits at min_len 5, ~320
# at the table's average) resolve most 1024-bit segments; the rest get a
# compacted device repair round.
PATCH_SYMS = 32

_PIPE_STATIC = ("need_words", "Bp", "seg_words", "max_syms", "lt", "impl")


@functools.partial(jax.jit, static_argnames=_PIPE_STATIC)
def _segments_pipeline_fast(buf, w0, start_bit, rs, *, need_words, Bp,
                            seg_words, max_syms, lt, impl):
    """One full pass + patch pass over the view ``buf[w0:w0+need_words]``.

    Pass 0's decode of each segment is already the true chain from its
    merge point onward — only the short head [true_entry, merge_point) is
    missing, so a PATCH_SYMS-slot pass from the true entries completes it.
    Returns (syms0 u8[Bp, max_syms], symsA u8[Bp, A], offs0 u16[Bp,
    max_syms], exits0, exitsA, blast0, badA, entries1).
    """
    jwords = jax.lax.dynamic_slice(buf, (w0,), (need_words,))
    seg_idx = jnp.arange(Bp, dtype=jnp.int32)
    bases = seg_idx * seg_words
    e0 = jnp.asarray(start_bit, jnp.int32)
    entries0 = jnp.where(seg_idx == 0, e0, 0)
    kw = dict(seg_words=seg_words, impl=impl)
    syms0, exits0, _bad0, offs0, blast0 = _seg_decode(
        jwords, bases, entries0, lt, steps=max_syms, emit_offs=True, **kw
    )
    entries1 = jnp.concatenate([e0[None], exits0[:-1] - seg_words * 32])
    entries1 = jnp.where(seg_idx < rs, entries1, 0)
    symsA, exitsA, badA, _o, _b = _seg_decode(
        jwords, bases, entries1, lt, steps=PATCH_SYMS, **kw
    )
    return syms0, symsA, offs0, exits0, exitsA, blast0, badA, entries1


def _exclusive_cumsum(x):
    """(exclusive prefix sum, total) in x's integer dtype."""
    c = jnp.cumsum(x)
    return c - x, c[-1]


# In-graph repair lanes: segments that do not merge within the patch are
# re-decoded from their true entries inside the dense program, up to this
# many per call; more punt to the host repair / fixpoint path.
R_MAX = 256


def _dense_core(buf, w0, start_bit, lengths, rs, *, need_words, Bp,
                seg_words, max_syms, lt, impl, n_dl=None):
    """One-pass + patch + DEVICE merge-stitch, repair and compaction.

    Runs the merge logic of ``_stitch_fast`` on device and COMPACTS the
    stitched chains into one dense u8 stream (per-segment output positions
    from a small scatter + cumsums, one flat gather), so the happy-path
    download is the decoded bytes and O(1) scalars.

    Returns (body_pad u8[N_pad], small, raw, cut) where raw is the
    `_segments_pipeline_fast` tuple for the host fallback (lazy device
    arrays; nothing transfers unless the caller materializes them).
    """
    A = PATCH_SYMS
    seg_bits = seg_words * 32
    raw = _segments_pipeline_fast(
        buf, w0, start_bit, rs, need_words=need_words, Bp=Bp,
        seg_words=seg_words, max_syms=max_syms, lt=lt, impl=impl,
    )
    syms0, symsA, offs0, exits0, exitsA, blast0, badA, entries1 = raw
    # All shapes run at the padded Bp bucket (pow2): the REAL segment
    # count ``rs`` is traced, so every chunked-stream size in a bucket
    # shares one compilation.
    starts0 = offs0.astype(jnp.int32)
    active = jnp.arange(Bp, dtype=jnp.int32) < rs
    e1 = entries1.astype(jnp.int32)

    count0 = jnp.sum((starts0 < seg_bits).astype(jnp.int32), axis=1)
    lensA = jnp.take(lengths, symsA.astype(jnp.int32), axis=0).astype(jnp.int32)
    pA = jnp.cumsum(lensA, axis=1) - lensA + e1[:, None]
    countA = jnp.sum((pA < seg_bits).astype(jnp.int32), axis=1)

    # First patch boundary that is also a pass-0 boundary: a broadcast
    # outer compare (S, A, max_syms) reduced in one fusion.
    big = jnp.int32(1 << 30)
    j_iota = jax.lax.broadcasted_iota(jnp.int32, (1, 1, max_syms), 2)
    eq = (starts0[:, None, :] == pA[:, :, None]) & (
        j_iota < count0[:, None, None]
    )
    j_min = jnp.min(jnp.where(eq, j_iota, big), axis=2)
    a_iota = jax.lax.broadcasted_iota(jnp.int32, (Bp, A), 1)
    hit = (j_min < big) & (a_iota < countA[:, None])
    any_hit = jnp.any(hit, axis=1)
    i_s = jnp.where(any_hit, jnp.argmax(hit, axis=1).astype(jnp.int32), 0)
    j_s = jnp.where(
        any_hit, jnp.take_along_axis(j_min, i_s[:, None], axis=1)[:, 0], 0
    )
    merge_bit = jnp.take_along_axis(pA, i_s[:, None], axis=1)[:, 0]
    tail_clean = (blast0 == 0) | (blast0 - 1 < merge_bit)
    use_tail = any_hit & tail_clean
    reached_end = countA < A
    resolved = (badA == 0) & (
        use_tail | (reached_end & (exitsA == exits0))
    )
    resolved = resolved | ~active
    fail = active & ~resolved

    i_eff = jnp.where(use_tail, i_s, countA)
    counts = jnp.where(active, i_eff + jnp.where(use_tail, count0 - j_s, 0), 0)

    # In-graph compacted repair: segments that don't merge within the
    # patch (random bytes x Kraft-incomplete tables) are re-decoded from
    # their true entries, one lane each, validated against pass 0's exits,
    # and spliced into the dense assembly and the cut.
    n_fail = jnp.sum(fail.astype(jnp.int32))
    posf = jnp.cumsum(fail.astype(jnp.int32)) - 1
    idx_r = jnp.zeros((R_MAX,), jnp.int32).at[
        jnp.where(fail & (posf < R_MAX), posf, R_MAX)
    ].set(jnp.arange(Bp, dtype=jnp.int32), mode="drop")
    lane_r = jnp.arange(R_MAX, dtype=jnp.int32)
    live = lane_r < jnp.minimum(n_fail, R_MAX)
    ent_r = jnp.where(live, jnp.take(e1, idx_r, mode="clip"), 0)
    rep_syms, exits_r, bad_r, _o, _b = _seg_decode(
        buf, w0 + idx_r * seg_words, ent_r, lt, steps=max_syms,
        seg_words=seg_words, impl=impl,
    )
    # equality with pass 0's exit proves its chain was synced by segment
    # end, so downstream entries were built on true boundaries
    valid_r = (~live) | (
        (bad_r == 0) & (exits_r == jnp.take(exits0, idx_r, mode="clip"))
    )
    repair_ok = (n_fail <= R_MAX) & jnp.all(valid_r)
    lens_r = jnp.take(lengths, rep_syms.astype(jnp.int32), axis=0).astype(jnp.int32)
    starts_r = (
        jnp.cumsum(lens_r, axis=1) - lens_r
        + jnp.take(e1, idx_r, mode="clip")[:, None]
    )
    counts_r = jnp.sum((starts_r < seg_bits).astype(jnp.int32), axis=1)
    drop_idx = jnp.where(live, idx_r, Bp)
    counts_spliced = counts.at[drop_idx].set(counts_r, mode="drop")
    lane_map = jnp.zeros((Bp,), jnp.int32).at[drop_idx].set(
        lane_r, mode="drop"
    )
    repaired = fail & repair_ok
    # assembly/cut channels: spliced when the repair stands, else the
    # pre-repair values so the host fallback sees the unrepaired contract
    # (its own repair path re-derives everything from `raw`)
    counts_asm = jnp.where(repair_ok, counts_spliced, counts)
    resolved_out = jnp.where(repair_ok, jnp.ones_like(resolved), resolved)

    # Dense assembly: out = concat_s(patch[s,:i_eff] + pass0[s,j_s:count0])
    # (or the repaired chain rep_syms[lane_map[s], :counts] wholesale).
    comb = jnp.concatenate([symsA, syms0], axis=1)  # (Bp, A + max_syms)
    stride = A + max_syms
    comb_flat = jnp.concatenate(
        [comb.reshape(Bp * stride), rep_syms.reshape(R_MAX * max_syms)]
    )
    pos_seg, total = _exclusive_cumsum(counts_asm)
    # Output slot grid: callers pass a rate-hint bucket ``n_dl``; slots
    # past it are never materialized — channel scatters drop, prefix sums
    # stay exact for the kept slots — and a body that outgrows the bucket
    # is reported via dl_over (capped callers size n_dl >= capacity and
    # only read past-cut slots when not over, so they never need the flag).
    N_pad = n_dl if n_dl is not None else Bp * stride
    dl_over = total > jnp.int32(min(N_pad, (1 << 31) - 1))
    base_seg = jnp.where(
        repaired,
        jnp.int32(Bp * stride) + lane_map * jnp.int32(max_syms),
        jnp.arange(Bp, dtype=jnp.int32) * stride,
    )
    i_eff_asm = jnp.where(repaired, counts_asm, i_eff)
    # per-output-slot owner data via scatter-of-deltas + cumsum: channels
    # = segment base in comb_flat, segment output start, i_eff, A + j_s.
    vals = jnp.stack([base_seg, pos_seg, i_eff_asm, jnp.int32(A) + j_s], axis=1)
    deltas = vals - jnp.concatenate(
        [jnp.zeros((1, 4), jnp.int32), vals[:-1]], axis=0
    )
    w4 = jnp.zeros((N_pad, 4), jnp.int32).at[pos_seg].add(
        deltas, mode="drop", indices_are_sorted=True
    )
    owner = jnp.cumsum(w4, axis=0)
    base_f, P, F, Jt = (owner[:, c] for c in range(4))
    u = jnp.arange(N_pad, dtype=jnp.int32) - P
    col = jnp.where(u < F, u, u - F + Jt)
    src = jnp.clip(base_f + col, 0, comb_flat.shape[0] - 1)
    body_pad = jnp.take(comb_flat, src)
    last_exit = jnp.take(exits0, jnp.clip(rs - 1, 0, Bp - 1))

    small = (
        total,
        repair_ok,
        last_exit,
        counts_asm,
        resolved_out,
        e1,
        exits0,
        dl_over,
    )
    cut = dict(
        counts=counts_asm, pA=pA, starts0=starts0, i_eff=i_eff_asm, j_s=j_s,
        repaired=repaired, lane_map=lane_map, starts_r=starts_r,
    )
    return body_pad, small, raw, cut


def _dl_bucket(est: int, full: int) -> int:
    """Slot-grid bucket: round ``est`` up to 1/8-pow2 granularity (<=12.5%
    overshoot, bounded compile count), clipped to the worst-case grid."""
    b = max(1024, min(int(est), full))
    if b >= full:
        return full
    k = max(0, b.bit_length() - 4)
    return min(full, -(-b >> k) << k)


def _learn_dl_rate(table, total_body: int, covered_bits: int) -> None:
    if covered_bits > 0 and total_body > 0:
        object.__setattr__(
            table, "_dec_rate_hint", 1.15 * total_body / covered_bits
        )


@functools.partial(jax.jit, static_argnames=_PIPE_STATIC + ("n_dl",))
def _segments_pipeline_dense(buf, w0, start_bit, lengths, rs, *, need_words,
                             Bp, seg_words, max_syms, lt, impl, n_dl=None):
    body_pad, small, raw, _cut = _dense_core(
        buf, w0, start_bit, lengths, rs, need_words=need_words, Bp=Bp,
        seg_words=seg_words, max_syms=max_syms, lt=lt, impl=impl, n_dl=n_dl,
    )
    return body_pad, small, raw


def _dense_capped_core(buf, w0, start_bit, lengths, rs, capacity, **kw):
    """Dense pipeline + the capacity cut computed ON DEVICE: the capped
    streaming drain needs (emitted symbols, resume bit, more) — with the
    cut segment and its boundary bit found here, one dispatch + one
    batched transfer covers the whole call.

    ``capacity`` is traced (no recompile per drain size). Returns
    (body_pad, small, raw, cut_small) with cut_small = (over bool,
    end_bit_cut i32 view-relative, total i32).
    """
    body_pad, small, raw, cut = _dense_core(
        buf, w0, start_bit, lengths, rs, **kw
    )
    Bp, max_syms = kw["Bp"], kw["max_syms"]
    seg_bits = kw["seg_words"] * 32
    counts = cut["counts"]
    cumc = jnp.cumsum(counts)
    total = small[0]
    cap = capacity.astype(jnp.int32)
    over = total > cap
    # segment holding symbol #cap (0-based), and the offset within it
    s_c = jnp.sum((cumc <= cap).astype(jnp.int32))
    s_cc = jnp.clip(s_c, 0, Bp - 1)
    before = jnp.where(s_c > 0, cumc[jnp.clip(s_c - 1, 0, Bp - 1)], 0)
    within = cap - before
    i_eff_c = cut["i_eff"][s_cc]
    head = within < i_eff_c
    jcol = jnp.clip(
        cut["j_s"][s_cc] + within - i_eff_c, 0, max_syms - 1
    )
    bitrel = jnp.where(
        head,
        cut["pA"][s_cc, jnp.clip(within, 0, PATCH_SYMS - 1)],
        cut["starts0"][s_cc, jcol],
    )
    # a cut inside an in-graph-repaired segment takes its boundary from
    # the repaired chain's starts instead of the patch/pass-0 ones
    bitrel = jnp.where(
        cut["repaired"][s_cc],
        cut["starts_r"][
            cut["lane_map"][s_cc], jnp.clip(within, 0, max_syms - 1)
        ],
        bitrel,
    )
    end_bit_cut = s_cc * jnp.int32(seg_bits) + bitrel
    return body_pad, small, raw, (over, end_bit_cut, total)


_segments_pipeline_dense_capped = jax.jit(
    _dense_capped_core, static_argnames=_PIPE_STATIC + ("n_dl",)
)


@functools.partial(jax.jit, static_argnames=_PIPE_STATIC + ("S",))
def _segments_pipeline(buf, w0, start_bit, *, need_words, S, Bp, seg_words,
                       max_syms, lt, impl):
    """Fused device program: view slice + fixpoint passes. Returns
    (syms u8[Bp, max_syms], entries[Bp], exits[Bp], bad[Bp], converged)."""
    jwords = jax.lax.dynamic_slice(buf, (w0,), (need_words,))
    # The while_loop inside stops as soon as entries converge (usually 2-3
    # passes); Bp+1 is the worst-case bound (degenerates to sequential).
    syms, exits, bad, converged, entries = _selfsync_passes(
        jwords, S, Bp, max_syms, Bp + 1, lt, impl, seg_words, start_bit,
    )
    return syms, entries, exits, bad, converged


class _WordsReader:
    """Host int-value reads over a device word buffer's view frame.

    View frame: bit 0 = MSB of ``buf[w0]``; valid through ``total_bits``.
    Downloads only the words covering the requested range (the streaming
    contract: host touches emitted bytes, O(1) scalars, and — near the
    stream end — the tail bytes).
    """

    def __init__(self, buf, w0: int, total_bits: int):
        self.buf, self.w0, self.total_bits = buf, w0, total_bits

    def value(self, from_bit: int, limit_bit: int) -> tuple[int, int]:
        """(int of view bits [from_bit, min(limit, total)), their count)."""
        limit_bit = min(limit_bit, self.total_bits)
        nbits = limit_bit - from_bit
        if nbits <= 0:
            return 0, 0
        a = from_bit >> 5
        nw = -(-(limit_bit - (a << 5)) // 32)
        size = max(16, 1 << (nw - 1).bit_length())  # bucket: few compiles
        buf = self.buf
        if self.w0 + a + size > buf.shape[0]:
            buf = jnp.pad(buf, (0, self.w0 + a + size - buf.shape[0]))
        wds = np.asarray(_dslice(buf, jnp.int32(self.w0 + a), size))[:nw]
        v = int.from_bytes(wds.astype(">u4").tobytes(), "big")
        head = from_bit - (a << 5)
        tot = nw * 32
        v &= (1 << (tot - head)) - 1
        v >>= tot - (limit_bit - (a << 5))
        return v, nbits


def selfsync_decode_words(
    buf,
    nbytes: int,
    consumed_bit: int,
    table: HuffmanTable,
    seg_words: int = SEG_WORDS,
    impl: str | None = None,
) -> tuple[bytes, int]:
    """Device-resident uncapped decode over a retained word buffer.

    ``buf``: uint32 device words (big-endian bit order, bitpack layout);
    the valid stream is the first ``nbytes`` bytes and bits past it are
    zero; everything before ``consumed_bit`` is already consumed. Unlike
    :func:`selfsync_decode_ex` the stream is never re-uploaded — the only
    transfers are the decoded symbols (D2H) and the small tail read.
    Returns (symbols, end_bit) with ``end_bit`` absolute in buf's frame.
    """
    w0 = consumed_bit >> 5
    sb = consumed_bit - (w0 << 5)
    base = w0 << 5
    total_bits = nbytes * 8 - base
    if total_bits <= sb:
        return b"", consumed_bit
    reader = _WordsReader(buf, w0, total_bits)

    def host_all():
        value, nbits = reader.value(sb, total_bits)
        out, pos = _decode_tail_host(table, value, nbits)
        return bytes(out), base + sb + pos

    plan = _plan_segments(total_bits, seg_words)
    if plan is None:
        return host_all()
    S, Bp, seg_bits, need_words = plan
    seg = _segments_from_words(
        buf, table, seg_words, sb, S, Bp, seg_bits,
        w0=w0, need_words=need_words, dense=True, impl=impl,
    )
    if seg is None:  # non-convergence safeguard
        return host_all()
    if isinstance(seg[0], str):
        _tag, body_bytes, tail_start_bit = seg
    else:
        syms, starts, counts, bad_np, S, seg_bits, tail_start_bit = seg
        if (bad_np != 0).any():
            raise UnknownSymbolError()
        mask = np.arange(syms.shape[1])[None, :] < counts[:, None]
        body_bytes = syms[mask].tobytes()
    value, nbits = reader.value(tail_start_bit, total_bits)
    tail, pos = _decode_tail_host(table, value, nbits)
    return body_bytes + bytes(tail), base + tail_start_bit + pos


TAIL_WORDS = 3 * SEG_WORDS + 4  # covers any host-decoded stream tail


def _value_from_words_np(words_np: np.ndarray, base_bit: int, from_bit: int,
                         limit_bit: int) -> tuple[int, int]:
    """(int of bits [from_bit, limit_bit), count) from downloaded words.

    ``base_bit`` is the absolute bit of words_np[0]'s MSB; from/limit are
    absolute in the same frame. The host twin of _WordsReader.value over
    an already-transferred slice (the fused drain downloads the tail
    words with the body, so no second device read is needed).
    """
    nbits = limit_bit - from_bit
    if nbits <= 0:
        return 0, 0
    v = int.from_bytes(words_np.astype(">u4").tobytes(), "big")
    tot = words_np.size * 32
    head = from_bit - base_bit
    v &= (1 << (tot - head)) - 1
    v >>= tot - (limit_bit - base_bit)
    return v, nbits


@functools.partial(
    jax.jit,
    donate_argnums=(0,),
    static_argnames=_PIPE_STATIC + ("capped", "cap_slice", "n_dl"),
)
def _fused_drain_call(buf, up, cw, w0b, w0, sb, rs, capacity, lengths, sh, *,
                      capped, need_words, Bp, seg_words, max_syms, lt, impl,
                      cap_slice, n_dl=None):
    """ONE device program per streaming drain.

    Fuses the four dispatches a `decode_chunk` call would pay — compact
    slide, feed append, decode pipeline, tail-word read — into one
    program with one batched download.

    buf is donated: the returned new_buf is the remainder's new canonical
    buffer (slide by ``cw`` words, then ``up`` merged at word ``w0b``
    with byte phase ``sh``; up is all-zero/empty on pure drain calls).
    Returns (new_buf, body_pad[:cap_slice], small, cut_small, tailw) —
    ``tailw`` is the TAIL_WORDS-word window at the host-tail resume point
    so the caller can finish the stream tail without another device read.
    """
    n = buf.shape[0]
    # 1. compact slide (cw == 0 is a cheap full copy, fused with 2)
    padded = jnp.concatenate([buf, jnp.zeros(n, jnp.uint32)])
    buf = jax.lax.dynamic_slice(padded, (cw,), (n,))
    # 2. merge-append the new words. ``sh`` (the byte phase * 8) is traced
    # so one graph serves all four phases; double shifts keep sh == 0
    # defined.
    if up.shape[0]:
        shu = sh.astype(jnp.uint32)
        inv = (jnp.uint32(31) - shu)
        ext = jnp.concatenate([jnp.zeros(1, jnp.uint32), up])
        shifted = ((ext[:-1] << inv) << jnp.uint32(1)) | (ext[1:] >> shu)
        up = jnp.concatenate(
            [shifted, (up[-1:] << inv) << jnp.uint32(1)]
        )
        first = jax.lax.dynamic_index_in_dim(buf, w0b, keepdims=False)
        up = up.at[0].set(up[0] | first)
        buf = jax.lax.dynamic_update_slice(buf, up, (w0b,))
    # 3. decode (the dense pipeline pads internally if buf is short; the
    # caller sizes the buffer so it never is)
    kw = dict(need_words=need_words, Bp=Bp, seg_words=seg_words,
              max_syms=max_syms, lt=lt, impl=impl, n_dl=n_dl)
    if capped:
        body_pad, small, _raw, cut_small = _dense_capped_core(
            buf, w0, sb, lengths, rs, capacity, **kw
        )
    else:
        body_pad, small, _raw, _cut = _dense_core(
            buf, w0, sb, lengths, rs, **kw
        )
        cut_small = (jnp.bool_(False), jnp.int32(0), small[0])
    # 4. tail window at the resume point (host finishes the last partial
    # segment with exact reference termination rules)
    seg_bits = seg_words * 32
    last_exit = small[2]
    tail_start = rs * jnp.int32(seg_bits) + last_exit - jnp.int32(seg_bits)
    tws = jnp.clip(w0 + (tail_start >> 5), 0, n - TAIL_WORDS)
    tailw = jax.lax.dynamic_slice(buf, (tws,), (TAIL_WORDS,))
    return buf, body_pad[:cap_slice], small, cut_small, tailw


def fused_drain_words(
    buf,
    nbytes: int,
    consumed_bit: int,
    table: HuffmanTable,
    capacity: int | None,
    up: np.ndarray | None = None,
    up_bytes: int = 0,
    cw: int = 0,
    seg_words: int = SEG_WORDS,
    impl: str | None = None,
):
    """Streaming drain as one dispatch + one download; or None (caller
    falls back to the classic multi-dispatch path).

    ``buf``/``nbytes``/``consumed_bit`` describe the PRE-slide, PRE-append
    remainder; ``up`` holds the new bytes' words (packed from bit 0,
    zero-padded to a pow2 bucket), ``up_bytes`` their true byte count,
    ``cw`` the whole words to slide off the front first. ``buf`` must
    already have room for the slid+appended stream plus TAIL_WORDS.
    Returns (symbols, end_bit, more, new_buf) with end_bit in the POST
    frame, or None when the stream is too small for the lane path — the
    caller must then materialize the slide+append itself and run the
    classic path.

    Unresolved/corrupt streams ARE handled: the classic capped/uncapped
    functions re-run over new_buf (returned via the _FusedFallback
    exception) and own the exact error semantics.
    """
    if seg_words > SEG_WORDS:
        raise ValueError("TAIL_WORDS covers tails of <= 3 * SEG_WORDS words")
    nbytes2 = nbytes - 4 * cw + up_bytes
    consumed2 = consumed_bit - 32 * cw
    if consumed2 < 0:
        raise ValueError("cannot slide past the consumed bit")
    w0 = consumed2 >> 5
    sb = consumed2 - (w0 << 5)
    base = w0 << 5
    total_bits = nbytes2 * 8 - base
    if total_bits <= sb:
        return None
    min_len = max(int(table.min_len), 1)
    if capacity is None:
        prefix_bits = total_bits
        full = True
    else:
        need_bits = sb + (capacity + 1) * int(table.max_len) + 64
        view_words = -(-total_bits // 32)
        prefix_words = min(view_words, -(-need_bits // 32))
        full = prefix_words == view_words
        prefix_bits = total_bits if full else prefix_words * 32
    plan = _plan_segments(prefix_bits, seg_words)
    if plan is None:
        return None
    S, Bp, seg_bits, need_words = plan
    n_up = up.size if up is not None else 0
    need_total = max(
        w0 + need_words,
        (nbytes - 4 * cw) // 4 + n_up + 1,
        TAIL_WORDS,
    )
    if buf.shape[0] < need_total:
        # grow with the same 2x-headroom pow2 policy as _ensure_capacity;
        # one extra dispatch, only on growth calls (rare by construction)
        cap = max(2 << max(need_total - 1, 1).bit_length(), 1 << 12)
        grown = jnp.zeros(cap, jnp.uint32)
        buf = jax.lax.dynamic_update_slice(grown, buf, (0,))
    max_syms = -(-((seg_bits + table.max_len) // min_len + 1) // 4) * 4
    full_grid = Bp * (max_syms + PATCH_SYMS)
    if capacity is None:
        # slot grid from the learned decode rate (bytes per stream bit);
        # total_body > cap_slice falls back below, which also refreshes
        # the hint. First call: the min_len worst-case bound.
        rate = getattr(table, "_dec_rate_hint", None)
        est = (rate * total_bits) if rate is not None else (
            total_bits // min_len + 2
        )
        cap_slice = _dl_bucket(est, full_grid)
    else:
        cap_slice = min(int(capacity), S * (max_syms + PATCH_SYMS))
    n_dl = _dl_bucket(cap_slice, full_grid)
    up_j = jnp.asarray(
        up if up is not None else np.zeros(0, np.uint32)
    )
    sh = ((nbytes - 4 * cw) % 4) * 8
    new_buf, body_pad, small, cut_small, tailw = _fused_drain_call(
        buf, up_j, jnp.int32(cw), jnp.int32((nbytes - 4 * cw) // 4),
        jnp.int32(w0), jnp.int32(sb), jnp.int32(S),
        jnp.int32(min(capacity if capacity is not None else (1 << 30),
                      1 << 30)),
        jnp.asarray(table.lengths.astype(np.int32)), jnp.int32(sh),
        capped=capacity is not None, need_words=need_words, Bp=Bp,
        seg_words=seg_words, max_syms=max_syms,
        lt=LaneTable.for_table(table),
        impl=impl or dispatch.lane_impl("selfsync"),
        cap_slice=cap_slice, n_dl=n_dl,
    )
    body_cap, sm, cs, tailw_np = jax.device_get(
        (body_pad, small, cut_small, tailw)
    )
    total_body, all_ok, last_exit = int(sm[0]), bool(sm[1]), int(sm[2])
    if capacity is None:
        _learn_dl_rate(table, total_body, S * seg_bits)
    if not all_ok or (capacity is None and total_body > cap_slice):
        raise _FusedFallback(new_buf)
    tail_start_bit = S * seg_bits + last_exit - seg_bits
    tws = min(max(w0 + (tail_start_bit >> 5), 0),
              new_buf.shape[0] - TAIL_WORDS)
    tail_base = (tws - w0) * 32  # view-frame bit of tailw[0]'s MSB

    def tail_capped(budget: int, limit_bit: int):
        value, nbits = _value_from_words_np(
            tailw_np, tail_base, tail_start_bit,
            min(limit_bit, tail_base + TAIL_WORDS * 32),
        )
        try:
            out, pos = _decode_tail_host(table, value, nbits,
                                         max_syms=budget)
            state = _next_state(table, value, nbits, pos)
            if state == "unknown":
                raise UnknownSymbolError()
        except UnknownSymbolError as e:
            # buf was donated: hand the new buffer back with the error so
            # the caller can restore its state before re-raising
            raise _FusedFallback(new_buf, error=e)
        return bytes(out), tail_start_bit + pos, state == "more"

    if capacity is not None:
        over, end_cut = bool(cs[0]), int(cs[1])
        if over:
            return (
                body_cap[:capacity].tobytes(), base + end_cut, True, new_buf
            )
        out = body_cap[:total_body].tobytes()
        budget = int(capacity) - total_body
        tail, end, more = tail_capped(budget, prefix_bits)
        if not more and not full:
            # can't happen given the prefix bound; stay correct anyway
            raise _FusedFallback(new_buf)
        return out + tail, base + end, more, new_buf
    out = body_cap[:total_body].tobytes()
    tail, end, more = tail_capped(1 << 62, total_bits)
    return out + tail, base + end, False, new_buf


class _FusedFallback(Exception):
    """Fused drain hit a rare case (unresolved segments, prefix-bound
    miss, or an error after the buffer was donated); carries the already
    slid+appended buffer so the caller restores its state first, then
    either re-runs the classic path or re-raises ``error``."""

    def __init__(self, new_buf, error: Exception | None = None):
        super().__init__("fused drain fallback")
        self.new_buf = new_buf
        self.error = error


def selfsync_decode_capped_words(
    buf,
    nbytes: int,
    consumed_bit: int,
    table: HuffmanTable,
    capacity: int,
    seg_words: int = SEG_WORDS,
    impl: str | None = None,
) -> tuple[bytes, int, bool]:
    """Device-resident capped decode: at most ``capacity`` symbols.

    The device-resident twin of :func:`selfsync_decode_capped` (same
    reference check order — UNKNOWN before output-full,
    source/huffman.c:240-246 before :257 — same O(capacity) prefix bound).
    The retained stream stays on device across calls; per call the host
    receives only the emitted symbols plus O(segments) metadata.
    Returns (symbols, end_bit, more) with ``end_bit`` absolute in buf's
    frame.
    """
    if capacity < 0 or not 0 <= consumed_bit <= nbytes * 8:
        raise ValueError("capacity must be >= 0 and consumed_bit in range")
    w0 = consumed_bit >> 5
    sb = consumed_bit - (w0 << 5)
    base = w0 << 5
    total_bits = nbytes * 8 - base
    if total_bits <= sb:
        return b"", consumed_bit, False
    reader = _WordsReader(buf, w0, total_bits)

    def host_capped(from_bit: int, budget: int, limit_bit: int):
        value, nbits = reader.value(from_bit, limit_bit)
        out, pos = _decode_tail_host(table, value, nbits, max_syms=budget)
        state = _next_state(table, value, nbits, pos)
        if state == "unknown":
            raise UnknownSymbolError()
        return bytes(out), from_bit + pos, state == "more"

    # Prefix guaranteed to contain capacity+1 decodable symbols (or the
    # whole stream) — word granularity here vs the host twin's bytes, both
    # are >= the need_bits bound so the cap cut is never truncated.
    need_bits = sb + (capacity + 1) * int(table.max_len) + 64
    view_words = -(-total_bits // 32)
    prefix_words = min(view_words, -(-need_bits // 32))
    full = prefix_words == view_words
    prefix_bits = total_bits if full else prefix_words * 32

    plan = _plan_segments(prefix_bits, seg_words)
    impl = impl or dispatch.lane_impl("selfsync")
    if plan is not None:
        # Dense-capped fast path: merge-stitch, compaction AND the capacity
        # cut all on device — one dispatch plus one batched transfer of
        # (capacity-sized body slice, O(segments) metadata) per drain call.
        # Unresolved/corrupt streams fall through to the classic path
        # below, which owns exact error semantics.
        S, Bp, seg_bits, need_words = plan
        min_len = max(int(table.min_len), 1)
        max_syms = -(-((seg_bits + table.max_len) // min_len + 1) // 4) * 4
        jwords = buf
        if jwords.shape[0] < w0 + need_words:
            jwords = jnp.pad(jwords, (0, w0 + need_words - jwords.shape[0]))
        cap_slice = min(int(capacity), S * (max_syms + PATCH_SYMS))
        # capacity-sized slot grid: slots past the cut are never read when
        # over; when not over the body fits the capacity, so no dl_over
        # handling is needed on this path
        n_dl = _dl_bucket(cap_slice, Bp * (max_syms + PATCH_SYMS))
        body_pad, small, _raw, cut_small = _segments_pipeline_dense_capped(
            jwords, jnp.int32(w0), jnp.int32(sb),
            jnp.asarray(table.lengths.astype(np.int32)), jnp.int32(S),
            jnp.int32(min(capacity, 1 << 30)),
            need_words=need_words, Bp=Bp, seg_words=seg_words,
            max_syms=max_syms, lt=LaneTable.for_table(table), impl=impl,
            n_dl=n_dl,
        )
        body_cap, sm, cs = jax.device_get(
            (body_pad[:cap_slice], small, cut_small)
        )
        total_body, all_ok, last_exit = int(sm[0]), bool(sm[1]), int(sm[2])
        over, end_cut, _tot = bool(cs[0]), int(cs[1]), int(cs[2])
        if all_ok:
            if over:
                return (
                    body_cap[:capacity].tobytes(),
                    base + end_cut,
                    True,
                )
            out = body_cap[:total_body].tobytes()
            tail_start_bit = S * seg_bits + last_exit - seg_bits
            budget = capacity - total_body
            tail, end, more = host_capped(tail_start_bit, budget, prefix_bits)
            if not more and not full:
                tail, end, more = host_capped(tail_start_bit, budget, total_bits)
            return out + tail, base + end, more

    seg = None
    if plan is not None:
        S, Bp, seg_bits, need_words = plan
        seg = _segments_from_words(
            buf, table, seg_words, sb, S, Bp, seg_bits,
            w0=w0, need_words=need_words, impl=impl,
        )
    if seg is None:
        out, end, more = host_capped(sb, capacity, prefix_bits)
        if not more and not full:
            out, end, more = host_capped(sb, capacity, total_bits)
        return out, base + end, more

    syms, starts, counts, bad_np, S, seg_bits, tail_start_bit = seg
    return _cut_capped(
        syms, starts, counts, bad_np, S, seg_bits, tail_start_bit, capacity,
        lambda budget, limit_full: host_capped(
            tail_start_bit, budget, total_bits if limit_full else prefix_bits
        ),
        full, base,
    )


def _cut_capped(syms, starts, counts, bad_np, S, seg_bits, tail_start_bit,
                capacity, tail_fn, full, base):
    """Cut a host segment tuple at ``capacity`` symbols with the
    reference's check order; ``tail_fn(budget, limit_full)`` finishes the
    stream tail. Returns (symbols, end_bit + base, more)."""
    cum = np.cumsum(counts)
    total_body = int(cum[-1]) if S else 0

    # First invalid window on the converged chain (absolute bit), if any.
    bad_segs = np.flatnonzero(bad_np != 0)
    if bad_segs.size:
        s_b = int(bad_segs[0])
        bad_rel = int(bad_np[s_b]) - 1
        before_bad = int(cum[s_b - 1]) if s_b else 0
        before_bad += int((starts[s_b] < bad_rel).sum())
        if capacity >= before_bad:
            # The invalid window is reached within (or exactly at) the cap:
            # reference checks UNKNOWN before output-full (huffman.c:240-246
            # precede :257) -> raise.
            raise UnknownSymbolError()

    if total_body > capacity:
        # Cap cut lands inside the lane-decoded body.
        s_c = int(np.searchsorted(cum, capacity, side="right"))
        within = capacity - (int(cum[s_c - 1]) if s_c else 0)
        end_bit = s_c * seg_bits + int(starts[s_c, within])
        mask = np.arange(syms.shape[1])[None, :] < counts[:s_c, None]
        out = syms[:s_c][mask].tobytes() + syms[s_c, :within].tobytes()
        return out, base + end_bit, True

    # Body fits; finish in the tail with the remaining budget.
    mask = np.arange(syms.shape[1])[None, :] < counts[:, None]
    body = syms[mask].tobytes()
    budget = capacity - total_body
    tail, end, more = tail_fn(budget, False)
    if not more and not full:
        # Prefix exhausted below capacity without the real stream ending:
        # cannot happen given the prefix bound; decode the remainder against
        # the full stream to stay correct regardless.
        tail, end, more = tail_fn(budget, True)
    return body + tail, base + end, more


def selfsync_decode_capped(
    data: bytes | np.ndarray,
    table: HuffmanTable,
    capacity: int,
    seg_words: int = SEG_WORDS,
    start_bit: int = 0,
    impl: str | None = None,
) -> tuple[bytes, int, bool]:
    """Decode at most ``capacity`` symbols at device speed.

    Returns (symbols, end_bit, more): ``end_bit`` is the absolute bit
    offset after the last emitted symbol (the resume point); ``more`` is
    True iff at least one further symbol is decodable — the caller maps it
    to the SHORT_BUFFER protocol (reference: the output-full check runs
    before consuming, source/huffman.c:257-268, so a capped call is
    restartable). Reference check order is preserved: an invalid window
    (>= 32 bits left) that would be REACHED within the first ``capacity``
    symbols — or sits exactly at the cap boundary — raises
    UnknownSymbolError (source/huffman.c:240-246 run before the
    output-full check); one past it does not.

    Only a prefix of the input covering ``capacity + 1`` symbols is ever
    decoded, so a small-capacity call over a huge retained stream stays
    O(capacity), not O(stream).
    """
    if capacity < 0 or not 0 <= start_bit < 8:
        raise ValueError("capacity must be >= 0 and start_bit in [0, 8)")
    raw = bytes(data) if isinstance(data, (bytes, bytearray)) else np.asarray(
        data, dtype=np.uint8
    ).tobytes()
    value_cache: dict[int, int] = {}

    def bits_value(upto_bytes: int) -> int:
        if upto_bytes not in value_cache:
            value_cache[upto_bytes] = int.from_bytes(raw[:upto_bytes], "big")
        return value_cache[upto_bytes]

    def host_capped(from_bit: int, budget: int, prefix_bytes: int):
        """Host loop from ``from_bit`` for ``budget`` symbols over the
        prefix; returns (syms, end_bit, more) with reference check order."""
        nbits = prefix_bytes * 8 - from_bit
        value = bits_value(prefix_bytes) & ((1 << nbits) - 1) if nbits else 0
        out, pos = _decode_tail_host(table, value, nbits, max_syms=budget)
        state = _next_state(table, value, nbits, pos)
        if state == "unknown":
            raise UnknownSymbolError()
        return bytes(out), from_bit + pos, state == "more"

    # Input prefix guaranteed to contain capacity+1 decodable symbols (or
    # the whole stream): (cap+1)*max_len bits + a 32-bit lookahead window.
    need_bits = start_bit + (capacity + 1) * int(table.max_len) + 64
    prefix_bytes = min(len(raw), -(-need_bits // 8))
    full = prefix_bytes == len(raw)
    # Tail truncation caveat: a symbol whose code straddles the prefix end
    # is excluded by the host/tail termination rules, but the prefix bound
    # above guarantees capacity+1 FULL symbols fit unless the real stream
    # ends first — so the cap cut is never affected by truncation.
    prefix = raw[:prefix_bytes]

    seg = _selfsync_segments(prefix, table, seg_words, start_bit, impl=impl)
    if seg is None:
        out, end, more = host_capped(start_bit, capacity, prefix_bytes)
        if not more and not full:
            # Decoded fewer than capacity symbols without reaching the real
            # stream end — only possible when the prefix bound was not the
            # binding constraint (shouldn't happen); fall back to the full
            # stream for a correct answer.
            return host_capped(start_bit, capacity, len(raw))
        return out, end, more

    syms, starts, counts, bad_np, S, seg_bits, tail_start_bit = seg
    return _cut_capped(
        syms, starts, counts, bad_np, S, seg_bits, tail_start_bit, capacity,
        lambda budget, limit_full: host_capped(
            tail_start_bit, budget, len(raw) if limit_full else prefix_bytes
        ),
        full, 0,
    )
