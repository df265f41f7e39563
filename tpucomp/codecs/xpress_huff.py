"""Xpress-Huffman device codec — block-parallel encode/decode in JAX.

Capability parity: reference ``src/xpress_huff_compress.cpp`` /
``src/xpress_huff_decompress.cpp`` (SURVEY.md §2 row 5; mount unavailable —
format per [MS-XCA] §2.1–2.2, SURVEY.md §8.3).

Parallel model: each 64 KiB block carries its own Huffman table but block
boundaries in a multi-block stream are only discoverable by decoding, so
foreign multi-block streams take a speculative span-discovery path (or
the sequential oracle); the batched device path operates on batches of independent single-block units (this framework's
archive manifests record unit boundaries — SURVEY.md §5 long-context
note).  Every unit stream is a standard [MS-XCA] block, decodable by any
conforming decoder.

Decode: the 256-byte table prefix is unpacked vectorized; canonical
decoding is ARITHMETIC (per-level first-code/limit/base-rank vectors from
tpucomp.kernels.huffman) — no 32 K LUT.  A byte-per-step lockstep
lane-scan (kernels/lane_scan) drives the bit window (two-u16 prime,
refill-below-16 — [MS-XCA] §2.2.4 discipline, refills interleave with
escape bytes exactly as the spec reader does); each step decodes up to
SUBSTEPS symbols, reading level -> (first code, base rank) and canonical
rank -> symbol from the block's own tables (per-lane gather loads in the
GPU kernel).  Copy resolution reuses kernels.common.resolve_copies*.

Encode: shared match kernels; histogram via one-hot matmul bincount;
device Huffman (two-queue + 15-bit repair + canonical); a closed-form
layout reproduces the lazy-flush 16-bit-LE word writer bit-for-bit —
bit-field and byte-slot positions are a partition of the stream, so
word values and the final body assemble with segmented ORs and monotone
placements plus one delta-fill for the escape-byte interleave shift.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..errors import ArgError, DataError
from ..util import pad_batch
from ..kernels.common import (
    extend_saturated,
    hash_best_match,
    fill_records_delta,
    fill_records_delta2,
    greedy_commit,
    histogram_matmul,
    mxu_gather_rows,
    place_monotone,
    resolve_copies,
    resolve_copies_wide,
    run_matchlens,
    scatter_sorted_or,
)
from ..kernels.lane_scan import lane_scan, shl
from ..kernels.huffman import (
    MAX_CODE_LEN,
    canonical_from_lengths,
    huffman_code_lengths,
    rank_to_symbol_table,
)

MIN_MATCH = 3
BLOCK = 65536
NUM_SYMBOLS = 512
_COPY_BIT = 1 << 20


def max_payload(u: int) -> int:
    """Worst-case single-block payload: table + 2 bytes/input + slack."""
    return 256 + 2 * u + 16


def max_compressed_size(n: int) -> int:
    nblocks = max(1, (n + BLOCK - 1) // BLOCK)
    return nblocks * (256 + 8) + 2 * n + 4


def _unpack_table(payload):
    """payload [N, P] -> code lengths [N, 512] from the 256-byte prefix."""
    tb = payload[:, :256]
    lo = tb & 0xF
    hi = (tb >> 4) & 0xF
    return jnp.stack([lo, hi], axis=2).reshape(tb.shape[0], 512)


# --------------------------------------------------------------------------
# Decode
# --------------------------------------------------------------------------

# byte-role modes for the scan
_M_W0 = 0  # next byte = low byte of a refill word
_M_W1 = 1  # next byte = high byte of a refill word
_M_EB = 2  # escape byte
_M_E16A, _M_E16B = 3, 4
_M_E32A, _M_E32B, _M_E32C, _M_E32D = 5, 6, 7, 8

# pending-symbol states
_P_NONE = 0
_P_OFFSET = 1  # need obc offset bits (after refill)
_P_ESC = 2  # need length-escape bytes (offset already read)


def make_decoder(u: int, substeps: int = 5, jitter=None, want_span=False,
                 with_history=False, fast_resolve=False):
    """``fast_resolve``: archive fast path — insert cheap value-chase
    probe rounds in the far resolve (kernels/common._far_probe_round).
    Built for streams from the offset-resolved encoder profile
    (_native.xh_compress_resolved); bit-correct for ANY stream (the
    general doubling rounds still follow and no-op when cleared)."""
    if u > BLOCK:
        raise ArgError("XPRESS_HUFF units are single <= 64 KiB blocks")

    if with_history:
        # hist [N, 64 KiB] = the last already-decoded output bytes before
        # this block, hist_len [N] = how many are valid; back-references
        # may reach hist_len bytes before the block start ([MS-XCA] §2.1
        # cross-block window)
        def dech(payload, plen, out_len, hist, hist_len):
            return _decode_impl(payload, plen, out_len, u, substeps,
                                want_span, hist, hist_len)

        return (jitter or jax.jit)(dech)

    def dec(payload, plen, out_len):
        return _decode_impl(payload, plen, out_len, u, substeps, want_span,
                            fast_resolve=fast_resolve)

    return (jitter or jax.jit)(dec)


# int32 0/1 masks throughout the step body: the byte-role predicates
# partition active lanes, so selects become masked sums
def _mk(c):
    return c.astype(jnp.int32)


def _sel(mask, a, bb):  # mask in {0,1}: mask ? a : bb
    return bb + mask * (a - bb)


# lane_scan tables read by the parse step
_T_SYM, _T_FC, _T_BR = 0, 1, 2


def _decode_symbol(bitbuf, fc, lim, take):
    """Arithmetic canonical decode from the top 15 window bits.
    Returns (sym, length, found-mask)."""
    mk, sel = _mk, _sel
    iota16 = jnp.arange(MAX_CODE_LEN + 1, dtype=jnp.int32)[None, :]
    peek15 = (bitbuf >> 17) & 0x7FFF
    # level l matches when fc[l] <= peek_l < lim[l], peek_l = top l bits
    peek_l = peek15[:, None] >> (15 - iota16)  # [L, 16]
    okl = mk(peek_l >= fc) * mk(peek_l < lim) * mk(iota16 > 0)
    # first matching level
    l = jnp.min(sel(okl, iota16, jnp.int32(99)), axis=1)
    found = mk(l <= MAX_CODE_LEN)
    lc = jnp.minimum(l, MAX_CODE_LEN)
    # per-lane table reads: level -> (first code, base rank), then
    # canonical rank -> symbol
    rank = take(_T_BR, lc) + ((peek15 >> (15 - lc)) - take(_T_FC, lc))
    sym = take(_T_SYM, rank)
    return sym, lc, found


def _parse_step(carry, x, s, consts, take, U, SUBSTEPS):
    """One body byte of every block's bit reader (lane_scan body): the
    byte is a refill half-word or an escape byte; each completed refill
    or escape runs up to SUBSTEPS symbol decodes."""
    mk, sel = _mk, _sel
    (p, mode, pend, bitbuf, bitcount, lowbyte, obc_p, lh_p, off_p,
     len_acc, rpos, rval, err, bits_used, raw_used) = carry
    (b,) = x
    blen, out_len, hl, fc, lim = consts
    active = mk(s < blen) * mk(p < out_len)

    # ---- byte role ----
    is_w0 = active * mk(mode == _M_W0)
    is_w1 = active * mk(mode == _M_W1)
    is_eb = active * mk(mode == _M_EB)
    is_e16a = active * mk(mode == _M_E16A)
    is_e16b = active * mk(mode == _M_E16B)
    is_e32nd = active * mk(mode >= _M_E32A) * mk(mode < _M_E32D)
    is_e32d = active * mk(mode == _M_E32D)

    lowbyte = sel(is_w0, b, lowbyte)
    # span accounting: every escape-role byte is a raw interleave byte
    raw_used = raw_used + (is_eb | is_e16a | is_e16b | is_e32nd | is_e32d)
    # escape u16/u32 accumulation
    len_acc = sel(
        is_e16a | (active * mk(mode == _M_E32A)), b,
        sel(
            active * mk(mode == _M_E32B), len_acc | (b << 8),
            sel(active * mk(mode == _M_E32C), len_acc | (b << 16), len_acc),
        ),
    )

    # word refill completes on W1
    word = lowbyte | (b << 8)
    bitbuf = sel(is_w1, bitbuf | shl(word, 16 - bitcount), bitbuf)
    bitcount = bitcount + is_w1 * 16

    # ---- escape completions (produce a finished match) ----
    eb_done = is_eb * mk(b < 255)
    eb_more = is_eb * mk(b == 255)
    u16v = len_acc | (b << 8)
    e16_zero = is_e16b * mk(u16v == 0)
    e16_done = is_e16b * mk(u16v != 0)
    u32v = len_acc | (b << 24)
    e32_done = is_e32d
    esc_len = (
        eb_done * (b + 15 + MIN_MATCH)
        + e16_done * (u16v + MIN_MATCH)
        + e32_done * (u32v + MIN_MATCH)
    )
    esc_match = eb_done | e16_done | e32_done
    err = err | (esc_match * (mk(off_p > p + hl) | mk(p + esc_len > out_len)))
    rpos = sel(esc_match, p, rpos)
    rval = sel(esc_match, _COPY_BIT | off_p, rval)
    p = sel(esc_match, jnp.minimum(p + esc_len, U), p)

    mode = (
        is_w0 * _M_W1
        + eb_more * _M_E16A
        + is_e16a * _M_E16B
        + e16_zero * _M_E32A
        + is_e32nd * (mode + 1)
        + (1 - active) * mode
        # all completion/W1 paths -> provisional _M_W0 (== 0);
        # overridden after the sub-loop
    )
    pend = pend * (1 - esc_match)  # esc_match -> _P_NONE (== 0)

    # ---- symbol sub-loop after a completed refill / escape ----
    # The 32-bit prime: no decoding until the second word (s >= 3),
    # mirroring the spec reader ([MS-XCA] §2.2.4) so early escape
    # bytes land after the 4-byte prime.
    can_work = active * (esc_match | (is_w1 * mk(s >= 3)))
    work = can_work
    # snapshot after EVERY record-producing point: the pre-loop escape
    # completion, each substep's offset-completion, and each substep's
    # symbol decode — a later record must never overwrite an earlier
    # one before it is captured.
    recs = [(rpos, rval)]
    for _ in range(SUBSTEPS):
        # 1) pending offset bits
        do_off = work * mk(pend == _P_OFFSET) * mk(bitcount >= obc_p)
        obc_c = jnp.maximum(obc_p, 1)
        raw = (bitbuf >> (32 - obc_c)) & (jnp.left_shift(1, obc_c) - 1)
        raw = raw * mk(obc_p > 0)
        offv = jnp.left_shift(1, obc_p) | raw
        bitbuf = sel(do_off, bitbuf << obc_p, bitbuf)
        bitcount = bitcount - do_off * obc_p
        bits_used = bits_used + do_off * obc_p
        short = do_off * mk(lh_p < 15)
        mlen = lh_p + MIN_MATCH
        err = err | (short * (mk(offv > p + hl) | mk(p + mlen > out_len)))
        rpos = sel(short, p, rpos)
        rval = sel(short, _COPY_BIT | offv, rval)
        p = sel(short, jnp.minimum(p + mlen, U), p)
        off_p = sel(do_off, offv, off_p)
        pend = sel(short, jnp.int32(_P_NONE), sel(do_off, jnp.int32(_P_ESC), pend))
        recs.append((rpos, rval))
        # 2) fresh symbol
        do_sym = work * mk(pend == _P_NONE) * mk(bitcount >= 16) * mk(p < out_len)
        sym, slen, found = _decode_symbol(bitbuf, fc, lim, take)
        do_sym = do_sym * found
        bitbuf = sel(do_sym, bitbuf << slen, bitbuf)
        bitcount = bitcount - do_sym * slen
        bits_used = bits_used + do_sym * slen
        is_lit = do_sym * mk(sym < 256)
        rpos = sel(is_lit, p, rpos)
        rval = sel(is_lit, sym, rval)
        p = p + is_lit
        is_m = do_sym * mk(sym >= 256)
        msym = sym - 256
        obc_p = sel(is_m, msym >> 4, obc_p)
        lh_p = sel(is_m, msym & 0xF, lh_p)
        pend = sel(is_m, jnp.int32(_P_OFFSET), pend)
        work = work * mk(p < out_len)
        recs.append((rpos, rval))

    # SUBSTEPS must cover every symbol completable from one refill;
    # if decodable state remains, the next byte would be mis-consumed
    # as a refill word — flag rather than desync (host picks SUBSTEPS
    # from the table's min code length, so valid streams never hit
    # this).
    leftover = (
        can_work
        * mk(p < out_len)
        * (
            (mk(pend == _P_NONE) * mk(bitcount >= 16))
            | (mk(pend == _P_OFFSET) * mk(bitcount >= obc_p))
        )
    )
    err = err | leftover

    need_refill = mk(bitcount < 16)
    mode = sel(
        can_work,
        sel(mk(pend == _P_ESC) * (1 - need_refill), jnp.int32(_M_EB),
            jnp.int32(_M_W0)),
        mode,
    )

    return (
        (p, mode, pend, bitbuf, bitcount, lowbyte, obc_p, lh_p, off_p,
         len_acc, rpos, rval, err, bits_used, raw_used),
        tuple(r for rec in recs for r in rec),
    )


def parse_records(body, blen, out_len, lengths, U, SUBSTEPS, hist_len=None,
                  impl=None):
    """Byte-per-step lockstep bit reader over every block's body.

    Returns (rec_pos [N, S*NREC], rec_val, carry) with NREC = 1 +
    2*SUBSTEPS record snapshots per step, chronological and monotone."""
    N, S = body.shape
    _, fc, br, lim = canonical_from_lengths(lengths)
    sym_by_rank = rank_to_symbol_table(lengths)  # [N, 512]
    # cross-block window: offsets may reach hist_len bytes before the
    # block start (0 without history — block-confined refs only)
    hl = jnp.zeros(N, jnp.int32) if hist_len is None else hist_len
    z = jnp.zeros(N, jnp.int32)
    init = (z,) * 10 + (jnp.full((N,), -1, jnp.int32),) + (z,) * 4
    carry, ys = lane_scan(
        functools.partial(_parse_step, U=U, SUBSTEPS=SUBSTEPS), init,
        (body.T,), consts=(blen, out_len, hl, fc, lim),
        tables=(sym_by_rank, fc, br), impl=impl)
    # [S, 2*NREC, N] -> [N, S*NREC], chronological + monotone
    rec_pos = ys[:, 0::2, :].transpose(2, 0, 1).reshape(N, -1)
    rec_val = ys[:, 1::2, :].transpose(2, 0, 1).reshape(N, -1)
    return rec_pos, rec_val, carry


def _decode_impl(payload, plen, out_len, U, SUBSTEPS, want_span=False,
                 hist=None, hist_len=None, fast_resolve=False, impl=None):
    """Decode a batch of single-block units.

    ``want_span``: additionally return the exact byte span of the
    decoded block body per the writer's lazy-flush layout (oracle
    ``_block_byte_span``: 2*(2 + max(0, ceil(bits/16)-1)) + raw escape
    bytes) — the block-boundary discovery the one-shot multi-block
    decode needs ([MS-XCA] §2.1: boundaries are only discoverable by
    decoding)."""
    N, P = payload.shape
    rec_pos, rec_val, carry = parse_records(
        payload[:, 256:], plen - 256, out_len, _unpack_table(payload), U,
        SUBSTEPS, hist_len, impl)
    p_final, errk, bits_used, raw_used = (carry[0], carry[12], carry[13],
                                          carry[14])
    keep = min(U, (8 * (P - 256)) // _BUCKET_MCL.get(SUBSTEPS, 1) + 8)
    keep = -(-keep // 128) * 128
    out, err = _records_to_output(rec_pos, rec_val, p_final, errk,
                                  out_len, N, U, keep=keep, hist=hist,
                                  fast_resolve=fast_resolve)
    if not want_span:
        return out, err
    # oracle _block_byte_span: 2 priming words + lazy flushes + raws
    flushes = jnp.maximum(0, -(-bits_used // 16) - 1)
    span = 2 * (2 + flushes) + raw_used
    return out, err, span


# min code length guaranteed by each substep bucket (_substeps_for
# inverse): every decoded symbol consumes >= mcl bits, bounding the
# record count of a body (the fill's dedupe/compact keep bound)
_BUCKET_MCL = {3: 8, 5: 4, 9: 2, 17: 1}


def _records_to_output(rec_pos, rec_val, p_final, errk, out_len, N, U,
                       keep=None, hist=None, fast_resolve=False):
    """Shared decode tail: monotone token records -> output bytes.
    Records with key >= queries' range (sentinels) never bind.
    ``keep``: sound bound on real records per row — the fill dedupes and
    compacts the raw slot stream to it (overflow -> err).
    ``hist`` [N, HU]: already-decoded bytes preceding the block — the
    resolve runs over the concatenated [hist | block] row so copies may
    reach into history ([MS-XCA] §2.1 cross-block window; HU + U must
    stay <= 2^17, the far-round source-field width)."""
    j = jnp.broadcast_to(jnp.arange(U, dtype=jnp.int32)[None, :], (N, U))
    vpack, tokpos, ovf = fill_records_delta2(rec_pos, rec_val, U, keep=keep)
    err = (errk | ovf | (p_final < out_len).astype(jnp.int32)) != 0
    is_copy_j = (vpack & _COPY_BIT) != 0
    disp_j = vpack & (_COPY_BIT - 1)
    # periodic fold: byte k >= d into an OVERLAPPING match copies the
    # match's own first period (src = tokpos + k mod d) instead of
    # chasing a depth-k/d chain — one extra hop collapses the deep
    # chains long periodic matches otherwise feed the far rounds
    # ([MS-XCA] overlapping-copy semantics make both sources identical)
    rel = j - tokpos
    dispc = jnp.maximum(disp_j, 1)
    disp_j = jnp.where(
        is_copy_j & (rel >= dispc), rel - lax.rem(rel, dispc), disp_j)
    litv = jnp.where(is_copy_j, 0, vpack & 0x1FF)
    if hist is not None:
        HU = hist.shape[1]
        assert HU + U <= (1 << 17) and (HU + U) % 16 == 0
        is_copy_c = jnp.concatenate(
            [jnp.zeros((N, HU), bool), is_copy_j], axis=1)
        disp_c = jnp.concatenate(
            [jnp.zeros((N, HU), jnp.int32), disp_j], axis=1)
        lit_c = jnp.concatenate([hist & 0xFF, litv], axis=1)
        out = resolve_copies_wide(is_copy_c, disp_c, lit_c)[:, HU:]
        out = jnp.where(j < out_len[:, None], out, 0)
        return out, err
    if U >= 8192 and U % 16 == 0:
        # K-unrolled window scan: U/16 steps with one batched one-hot
        # each, instead of U per-position steps (64 KiB blocks)
        out = resolve_copies_wide(is_copy_j, disp_j, litv,
                                  fast=fast_resolve)
    else:
        out = resolve_copies(is_copy_j, disp_j, litv)
    out = jnp.where(j < out_len[:, None], out, 0)
    return out, err


# --------------------------------------------------------------------------
# Encode
# --------------------------------------------------------------------------

_RUN_DISPS = (1, 2, 3)


def make_encoder(u: int, jitter=None):
    if u > BLOCK:
        raise ArgError("XPRESS_HUFF units are single <= 64 KiB blocks")

    def enc(units, ulen):
        return _encode_impl(units, ulen, u)

    return (jitter or jax.jit)(enc)


def _encode_impl(units, ulen, U, impl=None):
    """Encode [N, U] blocks (U <= 65536) into single-block XH payloads.

    Stages: match-find + greedy commit -> per-position symbols ->
    histogram (sort) -> device Huffman + canonical codes -> layout scan
    reproducing the lazy-flush 16-bit-LE word writer -> gather-side byte
    assembly.  No scatters, no hardware gathers (see kernels.common).
    """
    N, n = units.shape
    pos = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[None, :], (N, n))
    in_len = ulen[:, None]

    # ---- candidates (window = whole block, [MS-XCA] §2.1) ----
    best_len = jnp.zeros((N, n), jnp.int32)
    best_disp = jnp.ones((N, n), jnp.int32)

    def consider(length, disp, cond):
        nonlocal best_len, best_disp
        better = cond & (length > best_len)
        best_len = jnp.where(better, length, best_len)
        best_disp = jnp.where(better, disp, best_disp)

    from ..config import DEFAULT as _CFG

    run_disps = _CFG.match.run_disps
    for d, ml in zip(run_disps, run_matchlens(units, run_disps)):
        consider(ml, jnp.full((N, n), d, jnp.int32), ml >= MIN_MATCH)
    hl, hd = hash_best_match(units, n, hash_bits=_CFG.match.hash_bits,
                             num_cands=_CFG.match.num_candidates,
                             cap=_CFG.match.cap)
    # unbounded exact lengths for cap-saturated matches (the reference
    # scan is uncapped; without this the capped finder loses the multi-
    # KB matches that cover ~12% of the bench corpus)
    hl = extend_saturated(hl, hd, _CFG.match.cap, n)
    consider(hl, hd, hl >= MIN_MATCH)
    if _CFG.match.second_hash_cands:
        h5l, h5d = hash_best_match(
            units, n, hash_bits=_CFG.match.hash_bits,
            num_cands=_CFG.match.second_hash_cands,
            cap=_CFG.match.cap, seed=5)
        h5l = extend_saturated(h5l, h5d, _CFG.match.cap, n)
        consider(h5l, h5d, h5l >= MIN_MATCH)

    best_len = jnp.minimum(best_len, in_len - pos)
    is_match = (best_len >= MIN_MATCH) & (pos + MIN_MATCH <= in_len)
    # lazy matching: defer when the next position matches strictly longer
    next_bl = jnp.concatenate(
        [best_len[:, 1:], jnp.zeros((N, 1), jnp.int32)], axis=1
    )
    is_match = is_match & ~(next_bl > best_len)

    # ---- greedy commit (K-unrolled sequential walk) ----
    committed = greedy_commit(is_match, best_len, pos < in_len, impl=impl)
    tok_copy = committed & is_match

    # ---- per-position symbols ----
    L = best_len - MIN_MATCH
    obc = 31 - lax.clz(jnp.maximum(best_disp, 1))
    lh = jnp.minimum(L, 15)
    sym = jnp.where(
        tok_copy, 256 | (obc << 4) | lh, units
    )
    sym = jnp.where(committed, sym, NUM_SYMBOLS)  # sentinel for histogram

    # ---- histogram (one-hot matmul bincount; sentinel 512 drops) ----
    freqs = histogram_matmul(sym, NUM_SYMBOLS)

    # ---- Huffman lengths + canonical codes ----
    lengths = huffman_code_lengths(freqs)
    codes, _, _, _ = canonical_from_lengths(lengths)

    # ---- per-position (code, len) lookup (one-hot gather over [512]) ----
    packed_tbl = (codes << 5) | lengths  # code<=15 bits, len<=15
    codelen_p = mxu_gather_rows(
        packed_tbl, jnp.minimum(sym, NUM_SYMBOLS - 1), nbits=20
    )
    code_p = codelen_p >> 5
    clen_p = codelen_p & 0x1F

    # ---- closed-form bitstream layout (no scan) ----
    # The reference's lazy-flush 16-bit-LE word writer is a pure function
    # of cumulative bits: bitcount stays in [0, 16] after every write
    # (each write is <= 15 bits, flush when > 16), so after B total bits
    # the flushed-word count is (B-1)>>4 and word w holds global bits
    # [16w, 16w+16) MSB-first.  Token bit offsets are one cumsum; each
    # <=15-bit field spans at most 2 words; word values assemble with a
    # segmented-OR sort fill; escape-byte interleaving positions follow
    # from per-token flush counts (decoder reads 2 words ahead).
    offraw = best_disp & (jnp.left_shift(1, obc) - 1)
    rem = L - 15
    has_esc = tok_copy & (lh == 15)
    esc_big = has_esc & (rem >= 255)
    nraw = jnp.where(has_esc, jnp.where(esc_big, 3, 1), 0)
    esc_b0 = jnp.where(esc_big, 255, jnp.maximum(rem, 0))
    # u16 escape value = L (always < 0x10000 for U <= 65536)
    esc_pack = esc_b0 | ((L & 0xFF) << 8) | (((L >> 8) & 0xFF) << 16)

    clen_p = jnp.where(committed, clen_p, 0)
    code_v = jnp.where(committed, code_p, 0)
    bitsA = clen_p  # huffman code field
    bitsB = jnp.where(tok_copy, obc, 0)  # offset raw-bits field
    offraw_v = jnp.where(tok_copy, offraw, 0)
    bits_tok = bitsA + bitsB
    Bafter = jnp.cumsum(bits_tok, axis=1)
    S_A = Bafter - bits_tok  # field A global bit offset
    S_B = S_A + bitsA
    ebytes = jnp.where(tok_copy, nraw, 0)
    Eafter = jnp.cumsum(ebytes, axis=1)
    E_p = Eafter - ebytes  # escape bytes before this token
    Btot = Bafter[:, -1]
    raw_total = Eafter[:, -1]
    flushes_after = jnp.maximum((Bafter - 1) >> 4, 0)
    F = jnp.maximum((Btot - 1) >> 4, 0)  # total flushed words

    # ---- word values, assembled token-major: a token's two fields span
    # at most 3 consecutive 16-bit words (bitsA + bitsB <= 30), so each
    # token's contributions c0/c1/c2 to words W, W+1, W+2 are closed-form
    # elementwise; the per-word OR over tokens is a segmented scan on the
    # (non-decreasing) word keys + one monotone placement + two rolls.
    # All traffic-bound (no one-hot matmul scatter, whose MACs would
    # scale as 4 streams x n records x n words).
    W_tok = S_A >> 4
    relA = S_A & 15
    relB = S_B - 16 * W_tok  # = relA + bitsA <= 30

    def rel_field(rel, b, v):
        """(lane, lo, hi): a b<=15-bit field at window bit offset rel
        (0..30) lands in window lane rel>>4 (lo part) and, on straddle,
        lane+1 (hi part), MSB-first within each 16-bit lane."""
        lane = rel >> 4
        fit = 16 - (rel & 15) - b
        lo = jnp.where(
            fit >= 0,
            jnp.left_shift(v, jnp.maximum(fit, 0)),
            jnp.right_shift(v, jnp.maximum(-fit, 0)),
        ) & 0xFFFF
        lo = jnp.where(b > 0, lo, 0)
        spill = (b > 0) & (fit < 0)
        hi = jnp.where(
            spill, jnp.left_shift(v, jnp.maximum(16 + fit, 0)) & 0xFFFF, 0
        )
        return lane, lo, hi

    _, a_lo, a_hi = rel_field(relA, bitsA, code_v)  # lane always 0
    b_lane, b_lo, b_hi = rel_field(relB, bitsB, offraw_v)
    c0 = a_lo | jnp.where(b_lane == 0, b_lo, 0)
    c1 = a_hi | jnp.where(b_lane == 0, b_hi, b_lo)
    c2 = jnp.where(b_lane == 1, b_hi, 0)

    WMAX = n + 8  # bits <= 15L+30M with L+3M <= n  =>  words <= 15n/16+1
    wq = jnp.broadcast_to(jnp.arange(WMAX, dtype=jnp.int32)[None, :], (N, WMAX))
    d0, d1, d2 = scatter_sorted_or(W_tok, (c0, c1, c2), WMAX)
    word_val = d0 | jnp.roll(d1, 1, axis=1) | jnp.roll(d2, 2, axis=1)
    nwords = F + (Btot - 16 * F > 0).astype(jnp.int32)
    # reserved-but-unwritten slots hold zeros (like the oracle writer)
    wval = jnp.where(wq < nwords[:, None], word_val, 0)

    # slot byte position: j<2 -> 2j; else 2j + (escape bytes before the
    # token that flushed word j-2) — the decoder reads 2 words ahead.
    # Delta-fill form: E_p of the FIRST token with flushes_after >= w-1
    # == Eafter of the LAST token with flushes_after <= w-2 (keys are
    # non-decreasing); no such token -> 0 = E_p[0]; all tokens before ->
    # Eafter[last] = raw_total.  Both match the escape-interleave spec.
    ef, _ = fill_records_delta(flushes_after, Eafter, WMAX)
    e_shift = jnp.concatenate(
        [jnp.zeros((N, 2), jnp.int32), ef[:, : WMAX - 2]], axis=1
    )
    wpos = jnp.where(wq < 2, 2 * wq, 2 * wq + e_shift)
    slots_total = 2 + F

    # ---- escape-byte start positions ----
    r_start = 4 + 2 * flushes_after + E_p

    # ---- byte assembly: the stream is a partition (positions disjoint),
    # word-slot bytes and escape bytes each form strictly increasing
    # position streams — monotone placements + rolls, OR-combined dense
    # (a plane's zero-valued placements never collide with real bytes).
    body_len = 2 * slots_total + raw_total
    PB = 2 * n + 16  # body capacity
    bq = jnp.broadcast_to(jnp.arange(PB, dtype=jnp.int32)[None, :], (N, PB))
    wvalid = wq < slots_total[:, None]
    blo, bhi = place_monotone(~wvalid, wpos, (wval & 0xFF, wval >> 8), PB)
    esc_vals = tuple(
        jnp.where(nraw > k, (esc_pack >> (8 * k)) & 0xFF, 0) for k in range(3)
    )
    e0, e1, e2 = place_monotone(nraw == 0, r_start, esc_vals, PB)
    body = (
        blo | jnp.roll(bhi, 1, axis=1)
        | e0 | jnp.roll(e1, 1, axis=1) | jnp.roll(e2, 2, axis=1)
    )
    body = jnp.where(bq < body_len[:, None], body, 0)

    # ---- table prefix ----
    tlo = lengths[:, 0::2]
    thi = lengths[:, 1::2]
    table = tlo | (thi << 4)  # [N, 256]

    payload = jnp.concatenate([table, body], axis=1)
    plen = 256 + body_len
    return payload, plen


# --------------------------------------------------------------------------
# Host wrappers
# --------------------------------------------------------------------------

_ENCODERS = {}


def _jit_key(jitter):
    return getattr(jitter, "key", None) if jitter is not None else None


def _enc_for(u, jitter=None):
    from ..config import DEFAULT as _CFG

    key = (u, _jit_key(jitter), _CFG.match.fingerprint())
    if key not in _ENCODERS:
        _ENCODERS[key] = make_encoder(u, jitter)
    return _ENCODERS[key]


def compress_units(units_data, unit_size=BLOCK, jitter=None, pad_to=None,
                   gather=np.asarray):
    """Compress byte units (each <= unit_size <= 64 KiB) as independent
    single-block XH streams (one batch call).  ``jitter``/``pad_to``/
    ``gather``: see dist.ShardedCodec."""
    if not units_data:
        return []
    from ..config import DEFAULT as _CFG

    # cap the widest single encode dispatch (config.encode_batch_cap);
    # slices share ONE compile and keep any mesh multiple
    g = pad_to or 8
    cap = max(g, (_CFG.encode_batch_cap * 65536) // unit_size // g * g)
    if pad_batch(len(units_data), pad_to) > cap:
        out = []
        for i in range(0, len(units_data), cap):
            out += compress_units(units_data[i : i + cap], unit_size,
                                  jitter, cap, gather)
        return out
    N = pad_batch(len(units_data), pad_to)
    units = np.zeros((N, unit_size), np.int32)
    ulen = np.zeros(N, np.int32)
    for i, ud in enumerate(units_data):
        a = np.frombuffer(ud, np.uint8)
        if len(a) > unit_size:
            raise ArgError("unit larger than unit_size")
        units[i, : len(a)] = a
        ulen[i] = len(a)
    payload, plen = _enc_for(unit_size, jitter)(
        jnp.asarray(units), jnp.asarray(ulen))
    payload = gather(payload)
    plen = gather(plen)
    return [
        payload[i, : int(plen[i])].astype(np.uint8).tobytes()
        for i in range(len(units_data))
    ]


_DECODERS = {}


def _dec_for(u, substeps, jitter=None, fast_resolve=False):
    key = (u, substeps, _jit_key(jitter), fast_resolve)
    if key not in _DECODERS:
        _DECODERS[key] = make_decoder(u, substeps, jitter,
                                      fast_resolve=fast_resolve)
    return _DECODERS[key]


def _min_code_len(streams):
    """Smallest code length used across the blocks' tables (host peek)."""
    m = 15
    for s in streams:
        tb = np.frombuffer(s[:256], np.uint8)
        lens = np.concatenate([tb & 0xF, tb >> 4])
        used = lens[lens > 0]
        if used.size:
            m = min(m, int(used.min()))
    return m


def _substeps_for(mcl: int) -> int:
    """Symbol sub-loop unroll needed per refill: ceil(16/min_len)+1,
    quantized to a small set to bound compile variants.  The 3-tier
    (min code length >= 8: high-entropy/binary blocks) runs 40% fewer
    substeps than the text-typical 5-tier."""
    need = -(-16 // max(mcl, 1)) + 1
    for cap in (3, 5, 9, 17):
        if need <= cap:
            return cap
    return 17


def decompress_units(streams, out_lens, unit_size=BLOCK, jitter=None,
                     pad_to=None, gather=np.asarray, fast_resolve=False):
    """Decompress a batch of independent single-block XH streams.

    One device call per batch: its scan length is the longest stream's
    and its symbol sub-loop the deepest any block's table needs.  The
    blocks run in parallel lanes, so splitting the batch by stream size
    or code length would add calls (and compiles) without shortening
    the longest walk.
    """
    if not streams:
        return []
    if any(o > unit_size for o in out_lens):
        raise ArgError("out_len larger than unit_size")
    N = pad_batch(len(streams), pad_to)
    # scan length = padded payload width: the batch's longest body in
    # 8 KiB steps, not the all-literals worst case
    max_body = max(len(s) for s in streams) - 256
    body_bucket = max(1024, -(-max_body // 8192) * 8192)
    P = min(max_payload(unit_size), 256 + body_bucket + 16)
    payload = np.zeros((N, P), np.int32)
    plen = np.zeros(N, np.int32)
    olen = np.zeros(N, np.int32)
    olen[: len(streams)] = np.asarray(out_lens, np.int32)
    for i, s in enumerate(streams):
        a = np.frombuffer(s, np.uint8)
        payload[i, : len(a)] = a
        plen[i] = len(a)
    substeps = _substeps_for(_min_code_len(streams))
    out, err = _dec_for(unit_size, substeps, jitter,
                        fast_resolve=fast_resolve)(
        jnp.asarray(payload), jnp.asarray(plen), jnp.asarray(olen)
    )
    out = gather(out)
    if gather(err)[: len(streams)].any():
        raise DataError("XpressHuff: malformed unit stream")
    return [
        out[i, : int(olen[i])].astype(np.uint8).tobytes()
        for i in range(len(streams))
    ]


# --------------------------------------------------------------------------
# One-shot device backend (registered as the "tpu" backend pair)
# --------------------------------------------------------------------------


def compress(data: bytes) -> bytes:
    """One-shot XH compress on device (reference ``ms_compress``
    semantics, SURVEY.md §2 row 1): 64 KiB blocks device-encoded in one
    batch and concatenated — exactly the standard multi-block layout
    ([MS-XCA] §2.1; the oracle writer emits the same block framing, so
    any conforming decoder takes the result).  Matches are confined to
    their block: valid streams, marginally larger near block starts
    than a cross-block-window encoder."""
    data = bytes(data)
    if not data:
        return b""
    units = [data[i : i + BLOCK] for i in range(0, len(data), BLOCK)]
    return b"".join(compress_units(units))


_SPAN_DECODERS = {}


def _kraft_candidates(arr: np.ndarray, max_cands: int = 512):
    """Candidate block-start offsets: positions whose next 256 bytes
    form a COMPLETE canonical Huffman table (Kraft sum over the 512
    4-bit lengths == 2^15).  Every real block start from a conforming
    encoder qualifies (complete codes; the rare degenerate
    single-symbol table is incomplete and is handled by the sequential
    fallback in the chain walk); random body bytes almost never do, so
    the candidate set is ~the true block starts plus noise.  One
    windowed cumsum over the stream — no decoding.

    Returns None when the stream is pathological (more than
    ``max_cands`` candidates): the caller then takes the sequential
    path."""
    n = len(arr)
    if n < 256:
        return np.empty(0, np.int64)
    lo = (arr & 0xF).astype(np.int64)
    hi = (arr >> 4).astype(np.int64)
    w = np.where(lo > 0, 1 << (15 - lo), 0) + np.where(
        hi > 0, 1 << (15 - hi), 0)
    c = np.concatenate([[0], np.cumsum(w)])
    sums = c[256:] - c[:-256]
    offs = np.nonzero(sums == (1 << 15))[0]
    if len(offs) > max_cands:
        return None
    return offs


def _decompress_speculative(data: bytes, out_len: int):
    """Multi-block one-shot decode in O(1) device dispatches
    (VERDICT r4 #7): instead of one dispatch per 64 KiB block (block
    boundaries are only discoverable by decoding — [MS-XCA] §2.1),

    1. scan the stream for Kraft-complete table candidates (host,
       no decode);
    2. ONE batched dispatch decodes every candidate as a speculative
       full block (fake all-zeros history so cross-block references
       parse; the byte SPAN of a block depends only on its symbol
       stream, never on the copied values, so every surviving
       candidate's span is exact);
    3. walk the span chain host-side from offset 0 (a missing or
       errored link falls back to one sequential block decode);
    4. fixpoint passes: re-decode all blocks batched with the real
       history windows from the previous pass until outputs are
       stable.  Streams without cross-block references converge in one
       pass (2 dispatches total); depth-k cross-block reference chains
       take k+1 passes.

    Returns the output bytes, or None to fall back to the sequential
    walk (pathological candidate count)."""
    arr = np.frombuffer(data, np.uint8)
    cands = _kraft_candidates(arr)
    if cands is None:
        return None
    nfull = out_len // BLOCK if out_len % BLOCK else out_len // BLOCK
    cands = cands[cands + 256 <= len(arr)]
    if len(cands) == 0:
        return None
    MP = max_payload(BLOCK)

    def batch_decode(offs, olens, hists, hlens):
        """One dispatch: decode blocks at ``offs`` with given history.
        Returns (outs [n, BLOCK] uint8, errs [n] bool, spans [n])."""
        P = min(MP, max(
            1024,
            -(-max(min(MP, len(arr) - o) for o in offs) // 16384) * 16384)
            + 16)
        slices = [data[o: o + P] for o in offs]
        ss = max(_substeps_for(_min_code_len([s])) for s in slices)
        key = (ss, True)
        if key not in _SPAN_DECODERS:
            _SPAN_DECODERS[key] = make_decoder(
                BLOCK, ss, want_span=True, with_history=True)
        N = pad_batch(len(offs))
        payload = np.zeros((N, P), np.int32)
        plen = np.zeros(N, np.int32)
        olen = np.zeros(N, np.int32)
        hist = np.zeros((N, BLOCK), np.int32)
        hlen = np.zeros(N, np.int32)
        for i, o in enumerate(offs):
            a = np.frombuffer(slices[i], np.uint8)
            payload[i, : len(a)] = a
            plen[i] = len(a)
            olen[i] = olens[i]
            if hists[i] is not None:
                t = np.frombuffer(hists[i], np.uint8)
                hist[i, BLOCK - len(t):] = t
            hlen[i] = hlens[i]
        out, err, span = _SPAN_DECODERS[key](
            jnp.asarray(payload), jnp.asarray(plen), jnp.asarray(olen),
            jnp.asarray(hist), jnp.asarray(hlen))
        return (np.asarray(out).astype(np.uint8), np.asarray(err),
                np.asarray(span))

    # ---- dispatch 1: speculative decode of every candidate ----
    offs = [int(o) for o in cands]
    outs, errs, spans = batch_decode(
        offs, [BLOCK] * len(offs), [None] * len(offs),
        [BLOCK] * len(offs))
    spec = {}
    for i, o in enumerate(offs):
        if not errs[i]:
            spec[o] = (outs[i, :BLOCK].tobytes(), int(spans[i]))

    # ---- chain walk (host): true block starts + spans ----
    chain = []  # (offset, block_out)
    off, produced = 0, 0
    seq_decodes = 0
    while produced < out_len:
        if off + 256 > len(data):
            raise DataError(
                "XpressHuff: stream ended before out_len bytes")
        block_out = min(BLOCK, out_len - produced)
        if block_out == BLOCK and off in spec:
            chain.append((off, BLOCK))
            off += 256 + spec[off][1]
        else:
            # not a candidate (degenerate table / partial last block):
            # one sequential decode discovers this link
            o2, e2, s2 = batch_decode(
                [off], [block_out], [None], [BLOCK])
            if e2[0]:
                raise DataError(
                    "XpressHuff: malformed stream (or a match "
                    "overrunning a 64 KiB block boundary; use "
                    "backend='cpu' or 'oracle')")
            spec[off] = (o2[0, :BLOCK].tobytes(), int(s2[0]))
            seq_decodes += 1
            chain.append((off, block_out))
            off += 256 + int(s2[0])
        produced += block_out

    # ---- fixpoint: real history windows until stable ----
    cur = [spec[o][0][:bo] for o, bo in chain]
    for _pass in range(len(chain)):
        hists = [None]
        for k in range(1, len(chain)):
            hists.append(cur[k - 1][-BLOCK:])
        offs = [o for o, _ in chain]
        olens = [bo for _, bo in chain]
        hlens = [0] + [len(h) for h in hists[1:]]
        o3, e3, _ = batch_decode(offs, olens, hists, hlens)
        if e3[: len(chain)].any():
            raise DataError(
                "XpressHuff: malformed stream (or a match overrunning "
                "a 64 KiB block boundary; use backend='cpu'/'oracle')")
        nxt = [o3[k, : olens[k]].tobytes() for k in range(len(chain))]
        stable = nxt == cur
        cur = nxt
        if stable:
            break
    return b"".join(cur)


def decompress(data: bytes, out_len=None) -> bytes:
    """One-shot XH decompress on device: sequential block walk with
    device decode + exact byte-span discovery per block (boundaries in
    a multi-block stream are only discoverable by decoding —
    [MS-XCA] §2.1).  Cross-block back-references (legal in foreign
    streams) resolve against a carried 64 KiB history window, so
    streams from any conforming encoder decode here.  Matches whose
    OUTPUT extent overruns a 64 KiB block boundary (no known encoder
    emits these; block framing after one is spec-ambiguous) are
    rejected with DataError — take backend="cpu"/"oracle".  Batched
    workloads should prefer decompress_units / tpucomp.dist
    (block-parallel, manifest-framed)."""
    data = bytes(data)
    if out_len is None:
        raise ArgError("XPRESS_HUFF decompression requires out_len")
    if out_len == 0:
        return b""
    if out_len > BLOCK:
        # multi-block: speculative span discovery batches the whole
        # stream into O(cross-block-chain-depth) dispatches instead of
        # one per block (see _decompress_speculative); None falls back
        # to the sequential walk below
        got = _decompress_speculative(data, out_len)
        if got is not None:
            return got
    parts = []
    off = 0
    produced = 0
    tail = b""  # last <= 64 KiB of produced output (the reach-back window)
    MP = max_payload(BLOCK)
    while produced < out_len:
        if off + 256 > len(data):
            raise DataError("XpressHuff: stream ended before out_len bytes")
        # bucket the slice width at 16 KiB so repeat calls reuse compiles
        avail = min(MP, len(data) - off)
        sb = max(1024, -(-(avail - 256) // 16384) * 16384)
        P = min(MP, 256 + sb + 16)
        rem = data[off : off + P]
        block_out = min(BLOCK, out_len - produced)
        ss = _substeps_for(_min_code_len([rem]))
        if ss not in _SPAN_DECODERS:
            _SPAN_DECODERS[ss] = make_decoder(BLOCK, ss, want_span=True,
                                              with_history=True)
        N = pad_batch(1)
        payload = np.zeros((N, P), np.int32)
        a = np.frombuffer(rem, np.uint8)
        payload[0, : len(a)] = a
        plen = np.zeros(N, np.int32)
        plen[0] = len(a)
        olen = np.zeros(N, np.int32)
        olen[0] = block_out
        # history right-aligned: hist[BLOCK - k] = output[-k]
        hist = np.zeros((N, BLOCK), np.int32)
        if tail:
            t = np.frombuffer(tail, np.uint8)
            hist[0, BLOCK - len(t):] = t
        hlen = np.zeros(N, np.int32)
        hlen[0] = len(tail)
        out, err, span = _SPAN_DECODERS[ss](
            jnp.asarray(payload), jnp.asarray(plen), jnp.asarray(olen),
            jnp.asarray(hist), jnp.asarray(hlen))
        if bool(np.asarray(err)[0]):
            raise DataError(
                "XpressHuff: malformed stream (or a match overrunning a "
                "64 KiB block boundary; use backend='cpu' or 'oracle')")
        block = np.asarray(out)[0, :block_out].astype(np.uint8).tobytes()
        parts.append(block)
        tail = (tail + block)[-BLOCK:]
        off += 256 + int(np.asarray(span)[0])
        produced += block_out
    return b"".join(parts)
