"""Shared match-finding and search primitives for the device codecs.

Reference-parity note: these subsume the reference's shared LZ77
dictionary / match-finder templates (``include/mscomp/Dictionary.h``,
SURVEY.md §2 row 7; mount unavailable) — designed data-parallel, without
scatters: hash chains become a sort, match scoring becomes word-wide
compares, run detection becomes a log-depth scan.  (The design came from
a machine without hardware gather/scatter; ROADMAP §3.1 replaces the
emulations with native gathers and scatters where the card measures
them faster.)
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from .lane_scan import lane_scan


_BIG = 1 << 29
SENT_KEY = 1 << 28  # empty-record key (matches kernels' SENT)


def fill_gather(data_keys, data_vals, query_keys, reduce=None):
    """For each query key q (per row): value of the last data entry with
    key <= q (ties among equal data keys: the latest in column order
    wins — lax.sort is stable).  Data/query keys may be in any order
    (results return in query-column order).

    Implementation: merge data+queries with one sort, forward-fill the
    last data value with a scan, then sort back by query origin.  2 sorts
    + 1 scan total, independent of access pattern.

    ``gather``: pass data_keys = iota, query_keys = indices for an exact
    arbitrary gather.  ``data_vals`` may be a tuple of arrays (all filled
    by the same keys); a tuple is returned then.

    ``reduce="or"``: instead of last-entry-wins, equal-key data entries
    are OR-combined (segmented OR rides the existing fill scan for free);
    a query gets the OR of ALL data entries at the largest key <= q.
    """
    single = not isinstance(data_vals, (tuple, list))
    vals_in = (data_vals,) if single else tuple(data_vals)
    if single and reduce is None:
        return _fill_gather_1(data_keys, vals_in[0], query_keys)
    out = _fill_gather_mono(data_keys, vals_in, query_keys, reduce)
    return out[0] if single else out


def _fill_gather_mono(data_keys, vals_in, query_keys, reduce=None):
    """Sort-merge fill (see fill_gather)."""
    N, P = data_keys.shape
    U = query_keys.shape[1]
    origin = jnp.broadcast_to(jnp.arange(U, dtype=jnp.int32)[None, :], (N, U))
    # data sorts before queries at equal key: key*2 vs key*2+1
    keys = jnp.concatenate([data_keys * 2, query_keys * 2 + 1], axis=1)
    zq = jnp.zeros((N, U), jnp.int32)
    pays = [jnp.concatenate([v, zq], axis=1) for v in vals_in]
    org = jnp.concatenate([jnp.zeros((N, P), jnp.int32), origin], axis=1)
    isq = jnp.concatenate(
        [jnp.zeros((N, P), jnp.int32), jnp.ones((N, U), jnp.int32)], axis=1
    )
    sorted_ops = lax.sort((keys, org, isq, *pays), dimension=1, num_keys=1)
    keys_s, org_s, isq_s = sorted_ops[0], sorted_ops[1], sorted_ops[2]
    pays_s = sorted_ops[3:]

    # Forward fill by log-depth associative scan, NOT lax.scan: a linear
    # scan pays a loop iteration per element; associative_scan is
    # ~log2(M) wide elementwise passes.
    hasd = 1 - isq_s  # data-entry flag

    if reduce is None:

        def comb(a, b):
            ha, va = a[0], a[1:]
            hb, vb = b[0], b[1:]
            pick_b = hb == 1
            return (
                ha | hb,
                *(jnp.where(pick_b, vb[i], va[i]) for i in range(len(va))),
            )

        filled = lax.associative_scan(comb, (hasd, *pays_s), axis=1)
        fills = filled[1:]
    elif reduce == "or":
        # segmented OR over equal keys (valid on key-sorted input)
        def comb(a, b):
            ha, ka, va = a[0], a[1], a[2:]
            hb, kb, vb = b[0], b[1], b[2:]
            pick_b = hb == 1
            merge = (ha == 1) & (hb == 1) & (ka == kb)
            return (
                ha | hb,
                jnp.where(pick_b, kb, ka),
                *(
                    jnp.where(
                        pick_b,
                        vb[i] | jnp.where(merge, va[i], 0),
                        va[i],
                    )
                    for i in range(len(va))
                ),
            )

        filled = lax.associative_scan(comb, (hasd, keys_s, *pays_s), axis=1)
        fills = filled[2:]
    else:  # pragma: no cover
        raise ValueError(reduce)

    outk = jnp.where(isq_s == 1, org_s, _BIG)  # query origin, or sink
    back = lax.sort((outk, *fills), dimension=1, num_keys=1)
    return tuple(v[:, :U] for v in back[1:])


def sort_rows(operands, num_keys=1):
    """lax.sort of every operand along axis 1 (per-row sort)."""
    return lax.sort(tuple(operands), dimension=1, num_keys=num_keys)


def _fill_gather_1(data_keys, data_val, query_keys):
    """Single-value fill_gather with 2-plane sorts.

    The general path sorts 5 operand planes (key, origin, is-query flag,
    payloads); here the is-query flag already lives in the key's low bit
    and a single mixed plane carries payload-for-data / origin-for-query
    (distinguished by that bit), so each lax.sort moves 2 planes instead
    of 5.
    """
    N, P = data_keys.shape
    U = query_keys.shape[1]
    origin = jnp.broadcast_to(jnp.arange(U, dtype=jnp.int32)[None, :], (N, U))
    keys = jnp.concatenate([data_keys * 2, query_keys * 2 + 1], axis=1)
    mixed = jnp.concatenate([data_val, origin], axis=1)
    keys_s, mixed_s = lax.sort((keys, mixed), dimension=1, num_keys=1)
    isq_s = keys_s & 1
    hasd = 1 - isq_s

    def comb(a, b):
        ha, va = a
        hb, vb = b
        return ha | hb, jnp.where(hb == 1, vb, va)

    # data rows feed their payload forward; query rows contribute nothing
    _, filled = lax.associative_scan(
        comb, (hasd, jnp.where(isq_s == 1, 0, mixed_s)), axis=1
    )
    outk = jnp.where(isq_s == 1, mixed_s, _BIG)  # query origin, or sink
    back = lax.sort((outk, filled), dimension=1, num_keys=1)
    return back[1][:, :U]





def compact_records(rec_pos, rec_val, keep, chunk, slab=8):
    """Compact a sparse chronological record stream (SENT-keyed empty
    slots) by sorting fixed-width column chunks so empties sink to each
    chunk's tail, keeping the first ``keep`` columns per chunk.

    Callers must guarantee ``keep`` bounds the real records per chunk
    (for Huffman parse streams this follows from the bucket's min code
    length: every decoded symbol consumes >= mcl bits).  ``overflow``
    reports any dropped real record (possible only if that bound is
    violated — OR it into the row's err).

    Real keys are strictly increasing across the row, so per-chunk
    sorting preserves global chronological order and the compacted
    stream feeds the record fills directly (kept SENT slots never bind:
    queries < SENT).

    Returns (pos [N, nchunk*keep], val, overflow [N] int32).
    """
    N, R = rec_pos.shape
    assert keep <= chunk
    rpad = -(-R // chunk) * chunk
    npad = -(-N // slab) * slab
    pk = jnp.pad(rec_pos, ((0, npad - N), (0, rpad - R)),
                 constant_values=SENT_KEY)
    pv = jnp.pad(rec_val, ((0, npad - N), (0, rpad - R)))
    pk, pv = lax.optimization_barrier((pk, pv))
    nslab = npad // slab
    nchunk = rpad // chunk

    def body(t, state):
        out_k, out_v, ovf = state
        si = (t // nchunk) * slab
        ci = (t % nchunk) * chunk
        k = lax.dynamic_slice(pk, (si, ci), (slab, chunk))
        v = lax.dynamic_slice(pv, (si, ci), (slab, chunk))
        ks, vs = lax.sort((k, v), dimension=1, num_keys=1)
        o = (ks[:, keep:] < SENT_KEY).any(axis=1).astype(jnp.int32)
        oc = lax.dynamic_slice(ovf, (si,), (slab,))
        ovf = lax.dynamic_update_slice(ovf, oc | o, (si,))
        co = (t % nchunk) * keep
        out_k = lax.dynamic_update_slice(out_k, ks[:, :keep], (si, co))
        out_v = lax.dynamic_update_slice(out_v, vs[:, :keep], (si, co))
        return out_k, out_v, ovf

    out_k = jnp.full((npad, nchunk * keep), SENT_KEY, jnp.int32)
    out_v = jnp.zeros((npad, nchunk * keep), jnp.int32)
    out_k, out_v, ovf = lax.fori_loop(
        0, nslab * nchunk, body, (out_k, out_v, jnp.zeros(npad, jnp.int32)))
    return out_k[:N], out_v[:N], ovf[:N]


def compact_monotone(empty, operands, keep=None):
    """Stable left-compaction of rows: non-empty entries keep their order
    and pack to the left; tail slots report empty.  Returns
    (operands_compacted, valid_mask) — sliced to ``keep`` columns if given.

    Sort-free: entry i's left-shift s_i = #empties before it is
    NON-DECREASING along the row, so LSB->MSB power-of-2 gather passes
    move every entry collision-free: after processing bits 0..b the
    intermediate positions q_i = p_i - (s_i mod 2^{b+1}) satisfy
    q_{i+1} - q_i >= t_{i+1} - t_i >= 1 (t = final target), i.e. they
    stay strictly increasing, and a slot's incoming and staying entries
    are never both present.  ceil(log2(R)) elementwise passes instead of
    the lax.sort a sort-based compaction pays.
    """
    ops = tuple(operands)
    N, R = empty.shape
    e = empty.astype(jnp.int32)
    # rem_i = #empties before entry i (= its total left shift); -1 = empty
    rem = jnp.where(empty, -1, jnp.cumsum(e, axis=1))
    nb = max(1, (R - 1).bit_length())
    cols = jnp.arange(R, dtype=jnp.int32)[None, :]

    # ONE pass instance via fori_loop (not nb unrolled passes): the pass
    # body on wide arrays is a large subgraph, and nb copies of it made
    # program size and compile time the bottleneck (XLA:CPU compiler
    # crashes in long suite runs).  Dynamic shifts use roll + edge
    # masking.
    def shl(x, sh, fill):
        return jnp.where(cols < R - sh, jnp.roll(x, -sh, axis=1), fill)

    def body(b, state):
        rem, ops = state
        sh = jnp.left_shift(jnp.int32(1), b)
        rem_s = shl(rem, sh, -1)
        move_in = (rem_s >= 0) & ((rem_s & sh) != 0)
        stay = (rem >= 0) & ((rem & sh) == 0)
        ops = tuple(
            jnp.where(move_in, shl(o, sh, 0), jnp.where(stay, o, 0))
            for o in ops)
        rem = jnp.where(move_in, rem_s - sh, jnp.where(stay, rem, -1))
        return rem, ops

    rem, ops = lax.fori_loop(0, nb, body, (rem, ops))
    valid = rem >= 0
    if keep is not None:
        ops = tuple(o[:, :keep] for o in ops)
        valid = valid[:, :keep]
    return ops, valid


def expand_monotone(empty, operands, shift, width):
    """Inverse of compact_monotone: entry at column c moves RIGHT to
    column c + shift[c], where shifts are non-decreasing among non-empty
    entries and targets strictly increase (< width).  Returns
    (operands_expanded, placed_mask) at ``width`` columns; slots that
    receive no entry read 0 / False.

    MSB->LSB power-of-2 passes — the mirror of compact_monotone's
    collision-freedom proof: applying high shift bits first keeps
    intermediate positions strictly increasing.
    """
    ops = tuple(operands)
    N, R = empty.shape
    if width > R:
        pad = ((0, 0), (0, width - R))
        empty = jnp.pad(empty, pad, constant_values=True)
        ops = tuple(jnp.pad(o, pad) for o in ops)
        shift = jnp.pad(shift, pad)
    rem = jnp.where(empty, -1, shift)
    nb = max(1, (width - 1).bit_length())
    cols = jnp.arange(width, dtype=jnp.int32)[None, :]

    # ONE pass instance via fori_loop, MSB->LSB (see compact_monotone on
    # why: program size, not FLOPs, was the cost)
    def shr(x, sh, fill):
        return jnp.where(cols >= sh, jnp.roll(x, sh, axis=1), fill)

    def body(i, state):
        rem, ops = state
        sh = jnp.left_shift(jnp.int32(1), nb - 1 - i)
        rem_s = shr(rem, sh, -1)
        move_in = (rem_s >= 0) & ((rem_s & sh) != 0)
        stay = (rem >= 0) & ((rem & sh) == 0)
        ops = tuple(
            jnp.where(move_in, shr(o, sh, 0), jnp.where(stay, o, 0))
            for o in ops)
        rem = jnp.where(move_in, rem_s - sh, jnp.where(stay, rem, -1))
        return rem, ops

    rem, ops = lax.fori_loop(0, nb, body, (rem, ops))
    return ops, rem == 0


def compact_chronological(rec_pos, rec_val, U, keep):
    """Dedupe + left-compact a chronological record stream to its first
    ``keep`` real records, for fill_records_delta.

    Handles both stream shapes the parse scans emit: SENT-keyed empty
    slots (Pallas event slots) and carry-replicated duplicates (XLA
    snapshot streams — consecutive slots repeating the same position;
    real records always advance the position, so a repeated position is
    always a replica and the FIRST occurrence carries the value).
    Replica detection is ADJACENT-only (slot i vs slot i-1): a replica
    separated from its original by a SENT slot would count as a real
    record — both emitters produce replicas contiguously, keep it so.

    Returns (pos, val, overflow): empty tail slots report pos = U
    (ignored by the fill); ``overflow`` flags rows with more than
    ``keep`` real records (impossible for streams that respect the
    caller's bound — OR it into err).
    """
    N = rec_pos.shape[0]
    prev = jnp.concatenate(
        [jnp.full((N, 1), -2, jnp.int32), rec_pos[:, :-1]], axis=1)
    empty = (rec_pos < 0) | (rec_pos >= U) | (rec_pos == prev)
    overflow = (
        jnp.sum((~empty).astype(jnp.int32), axis=1) > keep
    ).astype(jnp.int32)
    (p, v), valid = compact_monotone(empty, (rec_pos, rec_val), keep=keep)
    return jnp.where(valid, p, U), v, overflow


def _fill_expand(rec_pos, rec_vals, U, rings, keep=None):
    """Shared dense-fill core: out[n, j] = value of the last record with
    pos <= j (0 if none), for each value plane, plus an overflow flag.

    Requires record positions NON-DECREASING among real entries
    (pos outside [0, U) counts as empty).  Adjacent duplicate positions
    are allowed: the LAST of a contiguous equal-pos run wins (replicas
    from carry-replicated scan streams repeat the value, so last == the
    record; multi-writer streams like cumulative escape tables want
    later-wins).  Non-adjacent duplicates cannot occur on non-decreasing
    input.

    Pipeline — all elementwise log-depth passes, no sorts, no matmuls:
      1. dedupe to last-of-run, left-compact to ``keep`` dense columns
         (compact_monotone: strictly increasing positions after);
      2. per-record delta_i = (val_i - val_{i-1}) mod ring (trivial on
         the deduped dense array: one shift);
      3. monotone expand of the deltas to their byte positions
         (strictly increasing targets: collision-free);
      4. cumsum mod ring reconstructs the piecewise-constant fill
         (int32 wrap is harmless: every ring divides 2^32).

    Value invariant per plane: values < ring/2 so deltas fit mod ring.
    ``keep`` bounds real records per row (caller-guaranteed; the
    returned overflow flags violations).  Default keep = min(R, U)
    cannot overflow.  Replaces a one-hot matmul scatter (records x U
    MACs).
    """
    N, R = rec_pos.shape
    real = (rec_pos >= 0) & (rec_pos < U)
    nxt_pos = jnp.concatenate(
        [rec_pos[:, 1:], jnp.full((N, 1), -1, jnp.int32)], axis=1)
    nxt_real = jnp.concatenate(
        [real[:, 1:], jnp.zeros((N, 1), bool)], axis=1)
    last_of_run = real & ~(nxt_real & (nxt_pos == rec_pos))
    if keep is None:
        keep = min(R, U)
    keep = min(keep, R)
    cnt = jnp.sum(last_of_run.astype(jnp.int32), axis=1)
    overflow = (cnt > keep).astype(jnp.int32)
    ops, valid = compact_monotone(
        ~last_of_run, (rec_pos, *rec_vals), keep=keep)
    p, vs = ops[0], ops[1:]
    z1 = jnp.zeros((N, 1), jnp.int32)
    deltas = []
    for v, ring in zip(vs, rings):
        v = jnp.where(valid, v, 0)
        pv = jnp.concatenate([z1, v[:, :-1]], axis=1)
        deltas.append(jnp.where(valid, (v - pv) & (ring - 1), 0))
    col = jnp.arange(p.shape[1], dtype=jnp.int32)[None, :]
    shift = jnp.where(valid, p - col, 0)
    placed, _ = expand_monotone(~valid, tuple(deltas), shift, U)
    outs = tuple(jnp.cumsum(d, axis=1) & (ring - 1)
                 for d, ring in zip(placed, rings))
    return outs, overflow


def fill_records_delta(rec_pos, rec_val, U, keep=None):
    """Dense fill: out[n, j] = value of the last record with pos <= j
    (0 if none), for every j in [0, U).  Values < 2^21 (22-bit delta
    ring).  See _fill_expand for the contract; returns (fill, overflow).
    """
    (vf,), ovf = _fill_expand(rec_pos, (rec_val,), U, (1 << 22,), keep)
    return vf, ovf


def fill_records_delta2(rec_pos, rec_val, U, keep=None):
    """fill_records_delta that ALSO returns, per output byte, the
    POSITION of its binding record (the token start — needed by the
    periodic-fold in copy resolution).  Positions < U <= 2^16 ride a
    second delta plane (17-bit ring).  Returns (val_fill, pos_fill,
    overflow)."""
    (vf, pf), ovf = _fill_expand(
        rec_pos, (rec_val, rec_pos), U, (1 << 22, 1 << 17), keep)
    return vf, pf, ovf


def _scatter_planes(prow, plane, byteplanes, UR, rchunk=None, groups=None):
    """Shared one-hot matmul scatter core: sum byteplanes[b] at (prow, plane) into
    int32 [N, UR, 128] (combined with << 8b shifts; int32 wrap is the
    caller's concern).  prow == UR drops the record.  ``groups``
    partitions the byteplanes into independently-combined outputs (a
    tuple is returned then) — they share the one-hot operands and run
    in ONE stacked dot.

    Loop layout matters enormously: an OUTER row-slab loop keeps the
    accumulator tile tiny so the INNER record-chunk loop (which bounds
    the materialized one-hot operand to ~1 GB) does not re-stream a
    full-batch accumulator per chunk — the earlier record-chunk-only
    form paid ~0.5 GB of accumulator traffic per 128-record chunk and
    ran 13x slower at 896-row batches.
    """
    N, R = prow.shape
    nb = len(byteplanes)
    if groups is None:
        groups = [nb]
    assert sum(groups) == nb
    ngroups = len(groups)
    iota_ur = jnp.arange(UR, dtype=jnp.int32)
    iota_l = jnp.arange(128, dtype=jnp.int32)
    # row slab: accumulator [slab, UR, 128] int32 <= ~16 MB
    slab = max(8, min(N, (1 << 22) // max(1, UR * 128 * 4) // 8 * 8))
    # record chunk: one-hot [slab, rchunk, UR] bf16 <= ~1 GB.  The f32
    # exactness contract (each plane's per-chunk sum <= rchunk * 255 <
    # 2^24) requires rchunk <= 65536 regardless of the caller's value.
    if rchunk is None:
        rchunk = max(512, ((1 << 29) // max(1, slab * UR)) // 512 * 512)
    rchunk = min(rchunk, -(-R // 512) * 512, 65536)
    rpad = -(-R // rchunk) * rchunk
    npad = -(-N // slab) * slab
    prow = jnp.pad(prow, ((0, npad - N), (0, rpad - R)), constant_values=UR)
    plane = jnp.pad(plane, ((0, npad - N), (0, rpad - R)))
    bps = tuple(jnp.pad(bp, ((0, npad - N), (0, rpad - R)))
                for bp in byteplanes)
    ops = lax.optimization_barrier((prow, plane) + bps)
    prow, plane, bps = ops[0], ops[1], ops[2:]
    nrc = rpad // rchunk

    def row_slab(t, out):
        n0 = (t // nrc) * slab
        c0 = (t % nrc) * rchunk
        pr = lax.dynamic_slice(prow, (n0, c0), (slab, rchunk))
        pl = lax.dynamic_slice(plane, (n0, c0), (slab, rchunk))
        ohr = (pr[:, :, None] == iota_ur[None, None, :]).astype(jnp.bfloat16)
        ohl = pl[:, :, None] == iota_l[None, None, :]
        rhs = jnp.concatenate(
            [jnp.where(
                ohl,
                lax.dynamic_slice(bp, (n0, c0), (slab, rchunk))[:, :, None],
                0).astype(jnp.bfloat16) for bp in bps],
            axis=2)  # [slab, rchunk, 128*nb]
        g = lax.dot_general(
            ohr, rhs, (((1,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32)  # [slab, UR, 128*nb]
        news = []
        b0 = 0
        for gi, gn in enumerate(groups):
            add = g[:, :, 128 * b0 : 128 * (b0 + 1)].astype(jnp.int32)
            for b in range(1, gn):
                add = add + (
                    g[:, :, 128 * (b0 + b) : 128 * (b0 + b + 1)]
                    .astype(jnp.int32) << (8 * b))
            cur = lax.dynamic_slice(out[gi], (n0, 0, 0), (slab, UR, 128))
            news.append(lax.dynamic_update_slice(
                out[gi], cur + add, (n0, 0, 0)))
            b0 += gn
        return tuple(news)

    out = lax.fori_loop(
        0, (npad // slab) * nrc, row_slab,
        tuple(jnp.zeros((npad, UR, 128), jnp.int32)
              for _ in range(ngroups)))
    outs = tuple(o[:N] for o in out)
    return outs if ngroups > 1 else outs[0]


def place_monotone(empty, keys, vals, U, keep=None):
    """Dense placement of SORTED records: out[n, k] = the value whose
    key == k (0 where none).  Keys must be STRICTLY INCREASING among
    non-empty entries per row (keys outside [0, U) also count empty).
    ``vals`` may be a tuple (planes share the compaction/expand passes).

    compact_monotone + expand_monotone: all elementwise log-depth
    passes (traffic-bound) — replaces one-hot matmul scatters whose MACs
    scale as records x U.
    """
    single = not isinstance(vals, (tuple, list))
    vs = (vals,) if single else tuple(vals)
    N, R = keys.shape
    empty = empty | (keys < 0) | (keys >= U)
    if keep is None:
        keep = min(R, U)
    ops, valid = compact_monotone(empty, (keys, *vs), keep=keep)
    k, cvs = ops[0], ops[1:]
    col = jnp.arange(k.shape[1], dtype=jnp.int32)[None, :]
    shift = jnp.where(valid, k - col, 0)
    placed, _ = expand_monotone(~valid, cvs, shift, U)
    return placed[0] if single else placed


def scatter_sorted_or(keys, vals, U):
    """out[n, u] = OR of vals over entries with key == u (0 where none).

    Keys NON-DECREASING along the row; equal keys form contiguous runs
    (no gaps), OR-combined by a segmented scan; zero-valued placeholder
    entries are harmless.  Keys outside [0, U) are dropped.  ``vals``
    may be a tuple.  Same cost model as place_monotone.
    """
    single = not isinstance(vals, (tuple, list))
    vs = (vals,) if single else tuple(vals)
    N, R = keys.shape

    def comb(a, b):
        ka, va = a[0], a[1:]
        kb, vb = b[0], b[1:]
        same = ka == kb
        return (kb, *(vb[i] | jnp.where(same, va[i], 0)
                      for i in range(len(va))))

    scanned = lax.associative_scan(comb, (keys, *vs), axis=1)
    ovals = scanned[1:]
    nxt = jnp.concatenate(
        [keys[:, 1:], jnp.full((N, 1), -1, jnp.int32)], axis=1)
    out = place_monotone(keys == nxt, keys, ovals, U)
    return out[0] if single else out


def scatter_add_matmul(pos, val, U, nbits=16, rchunk=None):
    """out[n, j] = sum over records i of val_i where pos_i == j.

    Direct one-hot matmul scatter-add (no ordering
    requirement on ``pos``; entries outside [0, U) are dropped).  Exact:
    ceil(nbits/8) 8-bit bf16 byte planes with f32 accumulation — per
    chunk each plane sums <= rchunk * 255 < 2^24 (``rchunk`` is
    forwarded to the scatter core and clamped to 65536 there so the
    bound holds for any caller value).  For records with DISTINCT
    positions (bitstream fields, byte slots) the sum is the value
    itself, and disjoint-bit OR combining is exactly ADD.
    Values must be in [0, 2^nbits); cost is MAC-bound at
    planes * N * R * U MACs plus the R x U/128 one-hot traffic.
    """
    N, R = pos.shape
    real = (pos >= 0) & (pos < U)
    nplanes = min(4, -(-nbits // 8))
    UR = -(-U // 128)
    prow = jnp.where(real, pos >> 7, UR)
    plane = jnp.where(real, pos & 127, 0)
    v = jnp.where(real, val, 0)
    out = _scatter_planes(
        prow, plane,
        tuple(lax.shift_right_logical(v, 8 * b) & 0xFF
              for b in range(nplanes)),
        UR, rchunk=rchunk)
    return out.reshape(N, UR * 128)[:, :U]


def histogram_matmul(sym, nbins, nchunk=8192):
    """Per-row histogram: out[n, s] = count of sym[n, i] == s, for
    s < nbins (out-of-range symbols — e.g. sentinels — are dropped).
    One-hot matmul bincount; counts are f32-exact (< 2^24)."""
    N, n = sym.shape
    BR = -(-nbins // 128)
    srow = jnp.where((sym >= 0) & (sym < nbins), sym >> 7, BR)
    slane = sym & 127
    iota_br = jnp.arange(BR, dtype=jnp.int32)
    iota_l = jnp.arange(128, dtype=jnp.int32)
    npad = -(-n // nchunk) * nchunk
    srow = jnp.pad(srow, ((0, 0), (0, npad - n)), constant_values=BR)
    slane = jnp.pad(slane, ((0, 0), (0, npad - n)))
    srow, slane = lax.optimization_barrier((srow, slane))

    def chunk(c, acc):
        c0 = c * nchunk
        sr = lax.dynamic_slice(srow, (0, c0), (N, nchunk))
        sl = lax.dynamic_slice(slane, (0, c0), (N, nchunk))
        ohr = (sr[:, :, None] == iota_br[None, None, :]).astype(jnp.bfloat16)
        ohl = (sl[:, :, None] == iota_l[None, None, :]).astype(jnp.bfloat16)
        g = lax.dot_general(
            ohr, ohl, (((1,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32)
        return acc + g.astype(jnp.int32)

    cnt = lax.fori_loop(
        0, npad // nchunk, chunk, jnp.zeros((N, BR, 128), jnp.int32))
    return cnt.reshape(N, BR * 128)[:, :nbins]


def fill_gather_left(data_keys, data_vals, query_keys):
    """For each query q: value of the FIRST data entry with key >= q
    (the searchsorted-left counterpart of fill_gather).  Implemented by
    negating and flipping: first-key>=q on the original order is
    last-key<=-q on the reversed, negated arrays."""
    single = not isinstance(data_vals, (tuple, list))
    vals_in = (data_vals,) if single else tuple(data_vals)
    fk = -jnp.flip(data_keys, axis=1)
    fv = tuple(jnp.flip(v, axis=1) for v in vals_in)
    out = fill_gather(fk, fv, -query_keys)
    return out[0] if single else out


def gather_rows(data, idx):
    """Exact per-row gather data[n, idx[n, j]] via fill_gather (sorts)."""
    N, K = data.shape
    keys = jnp.broadcast_to(jnp.arange(K, dtype=jnp.int32)[None, :], (N, K))
    return fill_gather(keys, data, jnp.clip(idx, 0, K - 1))


def mxu_gather_rows(data, idx, qchunk=1024, nbits=32):
    """Exact per-row gather data[n, idx[n, j]] via one-hot matmuls.

    Gather as a matmul: split the table into [R, 128] tiles, one-hot the
    row index (exactly one 1.0 per query), contract, then select the lane
    with a 128-wide masked reduce.  Exactness: 8-bit bf16 byte planes —
    every f32 product/sum is an integer <= 255 (one-hot rows contribute
    a single term).  Cost ~K MACs/query per plane.  (An emulation from a
    machine without vector gather; ROADMAP §3.1 measures
    ``take_along_axis`` against it on the card.)

    Out-of-range idx reads 0 (clipped one-hot misses).  int32 in/out.
    ``nbits``: value width bound — plane-dots above ceil(nbits/8) are
    skipped (cost is MAC-bound at planes * N*Q*K MACs).
    """
    N, K = data.shape
    Q = idx.shape[1]
    R = -(-K // 128)
    nplanes = min(4, -(-nbits // 8))
    # bound the per-chunk dot output [N, qchunk, 128] f32 to ~1 GB: at
    # segment-level far rounds N is thousands of rows and a fixed
    # 1024-query chunk would allocate tens of GB (observed OOM)
    qchunk = min(qchunk, max(
        128, (1 << 30) // max(1, N * 128 * 4) // 128 * 128))
    d3 = jnp.pad(data, ((0, 0), (0, R * 128 - K))).reshape(N, R, 128)
    planes = [(lax.shift_right_logical(d3, 8 * b) & 0xFF)
              .astype(jnp.bfloat16) for b in range(nplanes)]
    iota_r = jnp.arange(R, dtype=jnp.int32)
    iota_l = jnp.arange(128, dtype=jnp.int32)
    qpad = -(-Q // qchunk) * qchunk
    ip = jnp.pad(idx, ((0, 0), (0, qpad - Q)))
    nq = qpad // qchunk

    def chunk(qi, acc):
        ic = lax.dynamic_slice(ip, (0, qi * qchunk), (N, qchunk))
        row = ic >> 7
        lane = ic & 127
        oh = (row[:, :, None] == iota_r[None, None, :]).astype(jnp.bfloat16)
        ohl = lane[:, :, None] == iota_l[None, None, :]
        v = jnp.zeros((N, qchunk), jnp.int32)
        for b, plane in enumerate(planes):
            g = lax.dot_general(
                oh, plane, (((2,), (1,)), ((0,), (0,))),
                preferred_element_type=jnp.float32)
            byte = jnp.sum(jnp.where(ohl, g, 0.0), axis=2).astype(jnp.int32)
            v = v | (byte << (8 * b))
        return lax.dynamic_update_slice(acc, v, (0, qi * qchunk))

    out = lax.fori_loop(
        0, nq, chunk, jnp.zeros((N, qpad), jnp.int32))
    return out[:, :Q]


def searchsorted_rows(keys, queries, side="right", steps=None):
    """Row-wise binary search over per-row sorted ``keys``.

    Returns, per query, the number of keys <= query (side='right') or
    < query (side='left').  Implemented as unrolled one-shot gathers —
    the scatter-free inverse of "place record at position".
    """
    M = keys.shape[1]
    if steps is None:
        # search interval is [0, M] inclusive -> M+1 states need
        # ceil(log2(M+1)) halvings
        steps = max(1, M.bit_length())
    lo = jnp.zeros_like(queries)
    hi = jnp.full_like(queries, M)
    for _ in range(steps):
        mid = (lo + hi) >> 1
        v = jnp.take_along_axis(keys, jnp.minimum(mid, M - 1), axis=1)
        go_right = (v <= queries) if side == "right" else (v < queries)
        go_right = go_right & (mid < M)
        lo = jnp.where(go_right, mid + 1, lo)
        hi = jnp.where(go_right, hi, mid)
    return lo


def _commit_step(carry, x, p, consts, take):
    """One position of the greedy cursor walk (lane_scan body)."""
    (nc,) = carry
    blen, ismatch, okpos = x
    commit = (p == nc) & (okpos != 0)
    nc = jnp.where(commit, p + jnp.where(ismatch != 0, blen, 1), nc)
    return (nc,), (commit.astype(jnp.int32),)


# Walks up to this many positions take the lax.scan even on the GPU:
# at LZNT1's 4 KiB chunks the kernel walk is faster alone but the whole
# encode call measured slower with it (PERF.md, PR 1); at 64 KiB units
# the kernel wins end to end.
COMMIT_SCAN_MAX_STEPS = 4096


def greedy_commit(is_match, best_len, okpos, impl=None):
    """Greedy LZ token-selection: walk p = 0..n-1 with a cursor, commit a
    token at the cursor, jump len (match) or 1 (literal).  Returns the
    committed mask [N, n].

    The chain is inherently sequential, with ~5 ops per position on [N]
    vectors: it runs as one lane_scan, 32 positions per loop iteration
    (see COMMIT_SCAN_MAX_STEPS for which implementation).
    """
    if impl is None and is_match.shape[1] <= COMMIT_SCAN_MAX_STEPS:
        impl = "scan"
    _, ys = lane_scan(
        _commit_step, (jnp.zeros(is_match.shape[0], jnp.int32),),
        (best_len.T, is_match.T, okpos.T), impl=impl, unroll=32)
    return ys[:, 0, :].T != 0


def le_words(x):
    """w[p] = little-endian 4-byte word starting at byte p (tail wraps;
    callers must exclude wrapped lanes)."""
    return (
        x
        | (jnp.roll(x, -1, axis=1) << 8)
        | (jnp.roll(x, -2, axis=1) << 16)
        | (jnp.roll(x, -3, axis=1) << 24)
    )


def hash_candidates(x, hash_bits=13, num_cands=2, pos_bits=None):
    """Per-position most-recent same-3-byte-hash candidate positions.

    Sort-based hash chains, scatter-free: sort (hash<<pos_bits | pos);
    equal-hash neighbors in sort order are the most recent earlier
    same-hash positions; a second sort keyed on position restores position
    order (the inverse permutation, gather-side).  Returns ``num_cands``
    arrays of candidate positions (-1 where none).
    """
    if num_cands <= 0:
        return []  # effort knob num_candidates = 0: no hash search
    N, n = x.shape
    if pos_bits is None:
        pos_bits = max(1, (n - 1).bit_length())
    tri = (
        x | (jnp.roll(x, -1, axis=1) << 8) | (jnp.roll(x, -2, axis=1) << 16)
    ).astype(jnp.uint32)
    h = ((tri * jnp.uint32(0x9E3779B1)) >> jnp.uint32(32 - hash_bits)).astype(
        jnp.int32
    )
    pos = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[None, :], (N, n))
    key = (h << pos_bits) | pos
    skey, spos = sort_rows((key, pos), num_keys=1)
    sh = skey >> pos_bits
    idx = jnp.arange(n, dtype=jnp.int32)[None, :]
    cands_sorted = []
    for k in range(1, num_cands + 1):
        prev_pos = jnp.roll(spos, k, axis=1)
        prev_h = jnp.roll(sh, k, axis=1)
        ok = (idx >= k) & (prev_h == sh)
        cands_sorted.append(jnp.where(ok, prev_pos, -1))
    out = sort_rows((spos, *cands_sorted), num_keys=1)
    return out[1:]


def hash_best_match(x, n, hash_bits=13, num_cands=2, cap=16,
                    pos_bits=None, max_disp=None, seed=3):
    """Best hash-chain match per position, computed IN SORT ORDER.

    Fuses hash_candidates + multi_matchlens: the cap/4 comparison words
    ride the hash sort as extra planes, so every candidate's words are
    a k-roll of its sort neighbors — the separate (4n-wide, ~11-plane)
    fill_gather disappears.  Returns (best_len, best_disp): longest
    capped match among the ``num_cands`` most recent same-hash earlier
    positions (ties -> most recent), (0, 1) where none.  Candidate set,
    lengths and tie-breaks are identical to the unfused pair.

    ``seed``: bytes hashed for the chain key (3 default; 5 biases the
    candidate set toward longer matches — a SECOND finder pass at
    seed=5 unioned with seed=3 recovers mid-length matches the 3-byte
    chains lose to depth, at the same sort shape per pass).
    """
    if seed not in (3, 5):
        raise ValueError(f"hash_best_match: seed must be 3 or 5, got {seed}")
    N, nx = x.shape
    if num_cands <= 0:
        z = jnp.zeros((N, n), jnp.int32)
        return z, jnp.ones((N, n), jnp.int32)
    if pos_bits is None:
        pos_bits = max(1, (n - 1).bit_length())
    nwords = cap // 4
    w = le_words(x)
    tri = (
        x | (jnp.roll(x, -1, axis=1) << 8) | (jnp.roll(x, -2, axis=1) << 16)
    ).astype(jnp.uint32)
    if seed == 5:
        hi = (jnp.roll(x, -3, axis=1)
              | (jnp.roll(x, -4, axis=1) << 8)).astype(jnp.uint32)
        tri = tri ^ (hi * jnp.uint32(0x85EBCA6B))
    h = ((tri * jnp.uint32(0x9E3779B1)) >> jnp.uint32(32 - hash_bits)).astype(
        jnp.int32)
    pos = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[None, :], (N, n))
    key = (h << pos_bits) | pos
    shifted = tuple(jnp.roll(w, -4 * t, axis=1) for t in range(nwords))
    # pos rides the key's low bits — no separate plane in the sort
    srt = sort_rows((key, *shifted), num_keys=1)
    skey, sw = srt[0], srt[1:]
    spos = skey & ((1 << pos_bits) - 1)
    sh = skey >> pos_bits
    idx = jnp.arange(n, dtype=jnp.int32)[None, :]
    best_len = jnp.zeros((N, n), jnp.int32)
    best_disp = jnp.ones((N, n), jnp.int32)
    for k in range(1, num_cands + 1):
        cand = jnp.roll(spos, k, axis=1)
        ok = (idx >= k) & (jnp.roll(sh, k, axis=1) == sh)
        if max_disp is not None:  # format window (e.g. XPRESS 8 KiB)
            ok = ok & (spos - cand <= max_disp)
        total = jnp.zeros((N, n), jnp.int32)
        alive = ok
        for t in range(nwords):
            off = 4 * t
            v = sw[t] ^ jnp.roll(sw[t], k, axis=1)
            tz = 32 - lax.clz(v & -v) - 1  # masked below where v == 0
            agree = jnp.where(v == 0, 4, tz >> 3)
            clip_m = ((spos + off) > (n - 4)) | (cand + off > n - 4)
            agree = jnp.where(clip_m, 0, agree)
            total = total + jnp.where(alive, agree, 0)
            alive = alive & (v == 0) & ~clip_m
        ml = jnp.where(ok, total, 0)
        better = ok & (ml > best_len)
        best_len = jnp.where(better, ml, best_len)
        best_disp = jnp.where(better, spos - cand, best_disp)
    # back to position order, (len, disp) packed into ONE payload plane
    # (len <= cap, disp-1 < n): a 2-plane un-sort instead of 3
    len_bits = max(1, int(cap).bit_length())
    packed = ((best_disp - 1) << len_bits) | best_len
    _, out = sort_rows((spos, packed), num_keys=1)
    return out & ((1 << len_bits) - 1), (out >> len_bits) + 1


def extend_saturated(length, disp, cap, n=None):
    """Exact unbounded lengths for cap-saturated hash matches by
    stride-doubling self-composition.

    The capped finder verifies x[p..p+len) == x[p-d..p-d+len) up to
    ``cap`` bytes.  If len[p] saturated AND the finder at p+stride
    chose the SAME displacement, the two verified agreements
    concatenate: invariant after round k — acc[p] = verified agreement
    length at (p, disp[p]) capped at stride_k, alive[p] = saturated at
    stride_k.  log2(n/cap) elementwise static-roll rounds recover the
    multi-KB matches the reference's uncapped scan finds (measured:
    native covered 12% of the bench corpus with len>192 matches the
    capped finder truncated).  Conservative wherever the chain picks a
    different candidate at p+stride — still a valid parse.
    """
    N, nx = length.shape
    if n is None:
        n = nx
    pos = jnp.arange(nx, dtype=jnp.int32)[None, :]
    acc = length
    alive = length >= cap
    stride = cap
    while stride < n:
        ok = alive & (pos + stride < n) \
            & (jnp.roll(disp, -stride, axis=1) == disp)
        acc = acc + jnp.where(ok, jnp.roll(acc, -stride, axis=1), 0)
        alive = ok & jnp.roll(alive, -stride, axis=1)
        stride *= 2
    return acc


def capped_matchlen(w, cand, valid, n, cap=16):
    """Match length (≤ cap) of each row vs itself at candidate positions
    (single-candidate wrapper over multi_matchlens)."""
    return multi_matchlens(w, [cand], [valid], n, cap=cap)[0]


def multi_matchlens(w, cands, valids, n, cap=16):
    """Match lengths (≤ cap) for SEVERAL candidate arrays at once.

    ``w`` is the le_words() view.  All candidates' cap/4 words are
    fetched with ONE multi-value fill_gather over concatenated queries —
    (n data + k*n queries) * (3 + cap/4) plane-cells instead of k
    separate fills at (2n) * (3 + cap/4) each (the encoder's dominant
    sort).  XOR + count-trailing-zeros finds the first differing byte
    (little-endian ⇒ low byte is first).  Windows clipped at the row
    tail earn no credit (always safe: the measured prefix is verified
    equal).
    """
    if not cands:
        return []  # num_candidates = 0: run matcher only
    N = w.shape[0]
    K = len(cands)
    pos = jnp.arange(n, dtype=jnp.int32)[None, :]
    keys = jnp.broadcast_to(pos, (N, n))
    nwords = cap // 4
    shifted = tuple(jnp.roll(w, -4 * t, axis=1) for t in range(nwords))
    clipped_c = [jnp.clip(c, 0, n - 1) for c in cands]
    queries = jnp.concatenate(clipped_c, axis=1)
    wbs_all = fill_gather(keys, shifted, queries)
    outs = []
    for k in range(K):
        cc = clipped_c[k]
        total = jnp.zeros_like(cc)
        alive = valids[k]
        for tword in range(nwords):
            off = 4 * tword
            wa = shifted[tword]  # w[pos + off]: uniform shift
            v = wa ^ wbs_all[tword][:, k * n : (k + 1) * n]
            tz = 32 - lax.clz(v & -v) - 1  # masked below where v == 0
            agree = jnp.where(v == 0, 4, tz >> 3)
            clip_m = ((pos + off) > (n - 4)) | (cc + off > n - 4)
            agree = jnp.where(clip_m, 0, agree)
            total = total + jnp.where(alive, agree, 0)
            alive = alive & (v == 0) & ~clip_m
        outs.append(jnp.where(valids[k], total, 0))
    return outs


def run_matchlens(x, disps):
    """Exact match lengths for fixed small displacements, all at once.

    For each d in ``disps``: ml_d[p] = length of the run of
    x[q] == x[q-d] starting at q = p (0 where p < d).  One reverse scan
    with len(disps) operands.  Catches RLE and short periods exactly —
    including arbitrarily long runs the capped hash scorer would truncate.
    """
    N, n = x.shape
    outs = []
    # leading-ones count via log-depth associative scan (reverse): the
    # monoid carries (count-of-left-edge-ones, segment-all-ones)
    # reverse=True flips the operand, so fn(a, b) receives a = the
    # original-RIGHT segment: concatenated value is (b ++ a)
    def comb(a, b):
        ca, aa = a
        cb, ab = b
        return cb + ab * ca, aa * ab

    for d in disps:
        eq = jnp.concatenate(
            [jnp.zeros((N, d), jnp.int32), (x[:, d:] == x[:, :-d]).astype(jnp.int32)],
            axis=1,
        )
        c, _ = lax.associative_scan(comb, (eq, eq), axis=1, reverse=True)
        outs.append(c)
    return outs


# --------------------------------------------------------------------------
# LZ copy resolution: windowed scan + tagged far pointers + sort rounds
# --------------------------------------------------------------------------

FAR_TAG = 1 << 24  # out-value tag: "pointer to earlier output position"
# Archive fast-path probe budget: number of value-chase probe rounds the
# decoder runs before the dense mop-up (_far_rounds fast=True).  The
# native archive encoders' depth bound defaults to this value
# (_native.xh_compress_resolved / xpress_compress_resolved), so archives
# written at default depth resolve entirely in the cheap probes; deeper
# depth bounds are still correct but their surplus chains fall through
# to the dense full-row level.
ARCHIVE_PROBE_BUDGET = 2
# Segment-level value-chase probe budget (the archive fast path inside
# _far_level_segmented): matches the native archive encoders'
# in-segment chain-length cap (tpucomp_native.c RW_CHAIN_CAP = 8) —
# a value-chase round resolves one chain link, so cap-8 chains clear
# in <= 8 cond-driven probes before any doubling round runs.
SEG_PROBE_BUDGET = 8
# In-scan exact window.  Measured on the bench corpus: ~79% of copy bytes
# have d <= 512 and the max far-chain depth is 5 (vs 9 at 256), so the
# far while_loop (which pointer-doubles: log2(depth) rounds of 2 sorts)
# converges in <= 3 rounds.  The window one-hot costs ~W ops/step in the
# resolve scan (512 is not re-tuned for the GPU).
RESOLVE_WINDOW = 512


def _resolve_window(window):
    """Resolve the in-scan window knob: explicit arg > config.DEFAULT
    (tpucomp.config.ResolveConfig.window, read at trace time)."""
    if window is not None:
        return window
    from ..config import DEFAULT

    return DEFAULT.resolve.window


def resolve_copies_wide(is_copy, disp, litv, window=None, unroll=16,
                        fast=False, max_hop=None):
    """resolve_copies for LONG rows (e.g. 64 KiB blocks): processes
    ``unroll`` output positions per scan step so the program has U/K steps
    and the window read is ONE batched [N, K, W] one-hot per step instead
    of K narrow ones.

    Semantics differ from resolve_copies only in the near-window: a
    source must lie in [step_start - W, j) rather than [j - W, j); the
    few refs in the gap are tagged far (the far rounds absorb them), so
    results are identical.
    """
    N, U = is_copy.shape
    W = _resolve_window(window)
    K = unroll
    assert U % K == 0 and W % K == 0
    iota_w = jnp.arange(W, dtype=jnp.int32)[None, :]
    iota_k = jnp.arange(K, dtype=jnp.int32)[None, :]

    def sm(x):  # [N, U] -> [U/K, N, K]
        return x.T.reshape(U // K, K, N).transpose(0, 2, 1)

    def step(win, xs):
        iscp, d, lv, j0 = xs  # [N, K], [N, K], [N, K], scalar
        jj = j0 + iota_k  # [1->N, K] global positions
        src = jj - d
        # pre-step window read: sources in [j0 - W, j0)
        near_pre = iscp & (src >= j0 - W) & (src < j0) & (src >= 0)
        widx = jnp.where(near_pre, src % W, 0)  # [N, K]
        oh = widx[:, :, None] == iota_w[None]  # [N, K, W]
        preval = jnp.sum(jnp.where(oh, win[:, None, :], 0), axis=2)
        # in-batch sources resolved by a tiny sequential unroll
        in_batch = iscp & (src >= j0)
        farptr = FAR_TAG | jnp.maximum(src, 0)
        vals = jnp.where(
            iscp,
            jnp.where(near_pre, preval, farptr),
            lv,
        )
        for k in range(1, K):
            # position k reads in-batch source src-j0 in [0, k)
            ohk = (src[:, k][:, None] - j0) == iota_k  # [N, K]
            bval = jnp.sum(jnp.where(ohk, vals, 0), axis=1)
            vals = vals.at[:, k].set(
                jnp.where(in_batch[:, k], bval, vals[:, k])
            )
        win2 = lax.dynamic_update_slice(win, vals, (0, j0 % W))
        return win2, vals

    _, out_T = lax.scan(
        step,
        jnp.zeros((N, W), jnp.int32),
        (
            sm(is_copy),
            sm(disp),
            sm(litv),
            jnp.arange(0, U, K, dtype=jnp.int32),
        ),
    )
    out = out_T.transpose(1, 0, 2).reshape(N, U)
    return _far_rounds(out, U, W - K, fast=fast, max_hop=max_hop)


def _gather18(table, idx):
    """Row gather of 18-bit values — the pointer-doubling fetch of
    every far level."""
    return mxu_gather_rows(table, idx, nbits=18)


def _far_probe_round(out, U):
    """One VALUE-CHASE round at ~1/6 the work of a doubling round: fetch
    ``probe[src]`` where probe = 256 for still-tagged entries, else the
    final byte (a single 9-bit plane).  Tags whose target is already
    final resolve; live targets leave the tag untouched (no pointer
    doubling).

    This is the archive fast path: streams from the native encoder's
    OPT_RESOLVE_OFFSETS + depth-bound profile guarantee every surviving
    tag's target is final after the segment level, so ONE probe replaces
    the 3-plane full-row doubling rounds.  Correct for ANY stream — the
    general rounds still run after (and no-op when the probe cleared
    everything)."""
    tagged = (out & FAR_TAG) != 0
    probe = jnp.where(tagged, 256, out & 0xFF)
    src = jnp.where(tagged, out & (FAR_TAG - 1), 0)
    fetched = mxu_gather_rows(probe, src, nbits=9)
    return jnp.where(tagged & (fetched < 256), fetched, out)


def _far_rounds(out, U, min_hop, fast=False, max_hop=None):
    """Resolve FAR_TAG pointer chains by iterated gathers.  Each round
    is pointer DOUBLING (a fetched tag is the target's own pointer, so
    every chain halves per round: log2(depth) rounds); round caps
    guarantee termination on corrupt (cyclic) streams.

    ``max_hop``: format-level bound on parse-emitted hop distances
    (plain Xpress passes its 8192-byte window).  When set, the segment
    level uses OVERLAPPED gather tables (_far_level_overlapped) that
    contain every in-window source — only periodic-fold tags (folded
    hops can exceed the window) ever reach the full-row machinery.

    The gathers are one-hot matmuls (mxu_gather_rows), whose cost is
    MAC-bound at planes * N * Q * K — so rounds run LEVEL-SEGMENTED:
    first with rows cut into 4 KiB segments (gather table K = 4096,
    16x cheaper per round; in-segment chains — the vast majority once
    the 512-byte near window has run — resolve here), then full-row
    rounds for the few chains that cross segment boundaries.  Values are
    re-encoded to 18 bits (resolved byte, or bit17 | local target) so
    each gather runs 3 plane-dots instead of 4.

    ``fast``: insert cheap value-chase probe rounds before the full-row
    doubling level — the archive fast path for offset-resolved streams
    (see _far_probe_round); semantics unchanged for any stream.
    """
    N = out.shape[0]
    # Schedule: cheap 4 KiB in-segment rounds (a level only runs when it
    # divides U evenly: the segment reshape needs it), then cond-driven
    # DENSE full-row doubling rounds; the dense full-row level runs last
    # as the mop-up (near-free once converged) and covers small U.
    levels = [(4096, 6)]
    # Archive round counts (census, benchmarks/analyze_chain_depth.py):
    # RW_CHAIN_CAP=8 streams need exactly 3 segment rounds (a depth-k
    # chain resolves in ceil(log2(k))+1 — the +1 fetches the terminus
    # VALUE after the pointer doubles onto it).  Rounds are cond-driven
    # (while + any()), not a static count.
    if (max_hop is not None and max_hop % 128 == 0
            and min_hop < 4096 < U and U % 4096 == 0):
        # probe budget 2, not SEG_PROBE_BUDGET: the overlap-mode
        # archive encoder allows chains up to RW_XP_CHAIN_CAP=32 links
        # (size sweep: cap 32 = +1.8%), which the ADOPTIVE doubling
        # rounds resolve in <= 6 rounds regardless — long value-chase
        # probe ladders would just precede the same doubling rounds.
        # Two probes still clear shallow corpora outright (the
        # progress-gated cond then skips doubling entirely).
        out = _far_level_overlapped(out, U, 4096, max_hop, cap=6,
                                    fast=fast,
                                    probe_budget=ARCHIVE_PROBE_BUDGET)
    else:
        # NOTE: fast-path value-chase probes are NOT run at this level:
        # probes resolve one chain link per round while the cond-driven
        # doubling rounds must run for the stacked/deep chains
        # regardless
        for S, cap in [(s, c) for s, c in levels
                       if min_hop < s < U and U % s == 0]:
            out = _far_level_segmented(out, U, S, cap=cap)
    if fast:
        # cond-driven value-chase probes, capped at the archive
        # encoder's depth budget (_native.*_compress_resolved default
        # max_depth=2): batches whose cross-segment tags the first
        # probe fully clears skip the second
        def pcond(state):
            st, r, changed = state
            return (changed & jnp.any((st & FAR_TAG) != 0)
                    & (r < ARCHIVE_PROBE_BUDGET))

        def pround(state):
            st, r, _ = state
            nxt = _far_probe_round(st, U)
            return nxt, r + 1, jnp.any(nxt != st)

        out, _, _ = lax.while_loop(
            pcond, pround, (out, jnp.int32(0), jnp.bool_(True)))
    out = _far_level_segmented(out, U, U)
    return jnp.where((out & FAR_TAG) != 0, 0, out)


def _far_level_overlapped(out, U, S, H, cap=None, fast=False,
                          probe_budget=None):
    """Far rounds with an OVERLAPPED gather table per segment: segment k
    gathers from row[k*S - H : k*S + S], so every hop whose source lies
    within H bytes of the segment is in-table.  For a format with a
    hard window (plain Xpress: offsets <= 8192, [MS-XCA] §2.3) and
    H = window, EVERY parse-emitted hop is in-table — cross-segment
    tags disappear and the expensive full-row rounds only ever see the
    periodic-fold tags (whose folded hop distance can exceed the
    window; see _records_to_output's fold).

    MACs per doubling round: N * nseg * S * (S+H) * 3 — at S=4096,
    H=8192 that is 5.3x cheaper than a full-row round at U=65536.
    ``fast`` prepends pair-packed single-plane value-chase probe rounds
    (cond-driven, ``probe_budget``): the archive encoder's overlap
    depth model caps chain links, so archives clear here and the
    doubling cond no-ops.  Same 18-bit absolute state encoding as
    _far_level_segmented; correctness for ANY stream (out-of-table or
    too-deep tags simply stay tagged and escalate)."""
    N = out.shape[0]
    assert U <= (1 << 17) and U % S == 0 and H % 128 == 0, (U, S, H)
    nseg = U // S
    NR = N * nseg
    K = S + H
    tagged = (out & FAR_TAG) != 0
    st_row = jnp.where(tagged, (1 << 17) | (out & (FAR_TAG - 1)),
                       out & 0x1FF)  # [N, U] absolute 18-bit state
    base = ((jnp.arange(NR, dtype=jnp.int32) % nseg) * S)[:, None]
    max_rounds = cap or (max(1, (S - 1).bit_length()) + 3)
    if probe_budget is None:
        probe_budget = SEG_PROBE_BUDGET

    def tables(st_r):
        padded = jnp.pad(st_r, ((0, 0), (H, 0)))
        tbl = jnp.stack([padded[:, k * S: k * S + K]
                         for k in range(nseg)], axis=1)
        return tbl.reshape(NR, K)

    def seg_view(st_r):
        return st_r.reshape(NR, S)

    def unview(st_s):
        return st_s.reshape(N, U)

    def chase_mask(st_s):
        live = (st_s >> 17) == 1
        srcp = st_s & 0x1FFFF
        return live & (srcp >= jnp.maximum(base - H, 0)) \
            & (srcp < base + S), srcp

    if fast:
        def probe_one(st_r):
            st_s = seg_view(st_r)
            chase, srcp = chase_mask(st_s)
            live_r = (st_r >> 17) == 1
            probe_r = jnp.where(live_r, 256, st_r & 0x1FF)
            ptbl = tables(probe_r)
            idx = jnp.where(chase, srcp - (base - H), 0)
            fetched = mxu_gather_rows(ptbl, idx, nbits=9)
            return unview(jnp.where(chase & (fetched < 256), fetched,
                                    st_s))

        # progress-gated like _far_level_segmented's probes: chains
        # stacked on an out-of-table (folded-periodic) hop cannot
        # value-chase-resolve here
        def pcond(state):
            st_r, r, changed = state
            ch, _ = chase_mask(seg_view(st_r))
            return changed & jnp.any(ch) & (r < probe_budget)

        def pround(state):
            st_r, r, _ = state
            nxt = probe_one(st_r)
            return nxt, r + 1, jnp.any(nxt != st_r)

        st_row, _, _ = lax.while_loop(
            pcond, pround, (st_row, jnp.int32(0), jnp.bool_(True)))

    def cond(state):
        st_r, r = state
        ch, _ = chase_mask(seg_view(st_r))
        return jnp.any(ch) & (r < max_rounds)

    def round_(state):
        st_r, r = state
        st_s = seg_view(st_r)
        chase, srcp = chase_mask(st_s)
        tbl = tables(st_r)
        f = _gather18(tbl, jnp.where(chase, srcp - (base - H), 0))
        return unview(jnp.where(chase, f, st_s)), r + 1

    st_row, _ = lax.while_loop(cond, round_, (st_row, jnp.int32(0)))
    live = (st_row >> 17) == 1
    return jnp.where(live, FAR_TAG | (st_row & 0x1FFFF), st_row & 0x1FF)


def _far_level_segmented(out, U, S, cap=None, static_rounds=None,
                         fast=False):
    """Pointer-doubling rounds with rows cut into S-wide segments (the
    gather table is the segment: MACs per round scale with S, not U).
    Chains whose current source crosses a segment boundary stay tagged
    for the next level.  ``cap`` bounds the rounds on non-final levels:
    deeper in-segment chains simply escalate (correctness unaffected),
    which beats paying diminishing-return rounds here.

    ``fast``: run pair-packed single-plane VALUE-CHASE probe rounds
    before the doubling rounds (the archive fast path, as in
    _far_probe_round but with the segment as the gather table — ~1/6
    the MACs of a 3-plane doubling round and 16x cheaper than a
    full-row probe).  Archive streams' in-segment chains are capped at
    RW_CHAIN_CAP=8 links by the encoder's depth model, so cond-driven
    probes clear them and the doubling loop's entry cond no-ops;
    semantics unchanged for any stream (probes only resolve tags whose
    target is already final).

    State encoding: 18 bits — resolved byte (<= 9 bits) or
    (1<<17) | absolute_source — so sources must fit 17 bits: U (and
    every segment base + offset) must be <= 2^17.  Decoder entry points
    enforce U <= 65536 (see codecs.*.make_decoder)."""
    N = out.shape[0]
    assert U <= (1 << 17) and U % S == 0, (U, S)
    nseg = U // S
    NR = N * nseg
    tagged = ((out & FAR_TAG) != 0).reshape(NR, S)
    src = (out & (FAR_TAG - 1)).reshape(NR, S)  # ABSOLUTE source
    base = ((jnp.arange(NR, dtype=jnp.int32) % nseg) * S)[:, None]
    max_rounds = cap or (max(1, (S - 1).bit_length()) + 3)
    # Absolute 18-bit state at every level: a chase that fetches an
    # out-of-segment pointer ADOPTS it (doubling past the segment), so
    # in-segment chains stacked on a cross-segment hop collapse onto
    # the cross TARGET here and cost the dense level only the one round
    # the archive depth model budgets.  (A 2-plane segment-local
    # encoding was tried r4: it cannot represent adopted pointers, the
    # stacked chains re-parked un-doubled, and archive streams paid 2
    # extra dense rounds — worse than the plane it saved.)
    st = jnp.where(tagged, (1 << 17) | src, out.reshape(NR, S) & 0x1FF)

    if fast:
        def probe_one(stv):
            live = (stv >> 17) == 1
            srcp = stv & 0x1FFFF
            chase = live & (srcp >= base) & (srcp < base + S)
            # probe plane: final byte, or 256 = "target still live"
            # (covers both locally-chasing and cross-segment entries)
            probe = jnp.where(live, 256, stv & 0x1FF)
            idx = jnp.where(chase, srcp - base, 0)
            fetched = mxu_gather_rows(probe, idx, nbits=9)
            return jnp.where(chase & (fetched < 256), fetched, stv)

        # progress-gated: a chain STACKED on a cross-segment hop never
        # value-chase-resolves at this level (its terminus is not final
        # here) — without the ``changed`` gate such tags would spin the
        # whole probe budget before the doubling rounds (which ADOPT
        # past the segment) get to run
        def pcond(state):
            stv, r, changed = state
            live = (stv >> 17) == 1
            srcp = stv & 0x1FFFF
            local = live & (srcp >= base) & (srcp < base + S)
            return changed & jnp.any(local) & (r < SEG_PROBE_BUDGET)

        def pround(state):
            stv, r, _ = state
            nxt = probe_one(stv)
            return nxt, r + 1, jnp.any(nxt != stv)

        st, _, _ = lax.while_loop(
            pcond, pround, (st, jnp.int32(0), jnp.bool_(True)))

    def cond(state):
        st, r = state
        live = (st >> 17) == 1
        srcp = st & 0x1FFFF
        local = live & (srcp >= base) & (srcp < base + S)
        return jnp.any(local) & (r < max_rounds)

    def round_(state):
        st, r = state
        live = (st >> 17) == 1
        srcp = st & 0x1FFFF
        chase = live & (srcp >= base) & (srcp < base + S)
        f = _gather18(st, jnp.where(chase, srcp - base, 0))
        return jnp.where(chase, f, st), r + 1

    if static_rounds is not None:
        for _ in range(static_rounds):
            st, _ = round_((st, jnp.int32(0)))
    else:
        st, _ = lax.while_loop(cond, round_, (st, jnp.int32(0)))
    live = (st >> 17) == 1
    res = jnp.where(live, FAR_TAG | (st & 0x1FFFF), st & 0x1FF)
    return res.reshape(N, U)


def resolve_copies(is_copy, disp, litv, window=None):
    """Resolve LZ77 copy chains without gathers.

    Inputs are dense per-output-position arrays [N, U]: is_copy (bool),
    disp (int32, valid where is_copy), litv (literal byte elsewhere).

    Stage 1 — one forward scan over output positions carrying a circular
    [N, window] buffer of the last ``window`` resolved values.  Processing
    in position order means every source (near or far) is already FINAL:
    near sources (d <= window) resolve via a one-hot select inside the
    register window; far sources store a tagged pointer FAR_TAG|src, and
    tags propagate unchanged through any near chain that copies them.
    This stage alone fully resolves RLE/periodic chains of ANY depth
    (their hops are small) — the classic pointer-doubling worst case.

    Stage 2 — remaining tagged entries are shallow-but-far chains; iterate
    sort-based gathers (fill_gather) until no tags remain.  Each round
    shortens every far chain by >= 1 hop; real data converges in 0–2
    rounds (the while_loop pays only what the batch needs).
    """
    N, U = is_copy.shape
    W = _resolve_window(window)
    iota_w = jnp.arange(W, dtype=jnp.int32)[None, :]

    def step(win, xs):
        iscp, d, lv, jj = xs
        near = iscp & (d <= jnp.minimum(jj, W))
        widx = jnp.where(near, (jj - d) % W, 0)
        oh = widx[:, None] == iota_w
        nearval = jnp.sum(jnp.where(oh, win, 0), axis=1)
        farptr = FAR_TAG | jnp.maximum(jj - d, 0)
        val = jnp.where(
            iscp, jnp.where(near, nearval, farptr), lv
        )
        win2 = lax.dynamic_update_slice(win, val[:, None], (0, jj % W))
        return win2, val

    _, out_T = lax.scan(
        step,
        jnp.zeros((N, W), jnp.int32),
        (is_copy.T, disp.T, litv.T, jnp.arange(U, dtype=jnp.int32)),
    )
    out = out_T.T

    jpos = jnp.broadcast_to(jnp.arange(U, dtype=jnp.int32)[None, :], (N, U))
    # Valid streams: every far hop reaches > window back, so chains have
    # <= U/(window+1) far hops.  Corrupt streams (err-flagged upstream)
    # can form pointer cycles — the round cap guarantees termination;
    # leftover tags are zeroed (the caller rejects the row via err).
    max_rounds = U // (W + 1) + 2

    def far_cond(state):
        out, r = state
        return jnp.any((out & FAR_TAG) != 0) & (r < max_rounds)

    def far_round(state):
        out, r = state
        tagged = (out & FAR_TAG) != 0
        tgt = jnp.where(tagged, out & (FAR_TAG - 1), jpos)
        fetched = mxu_gather_rows(out, tgt)
        return jnp.where(tagged, fetched, out), r + 1

    out, _ = lax.while_loop(far_cond, far_round, (out, jnp.int32(0)))
    return jnp.where((out & FAR_TAG) != 0, 0, out)
