"""Plain-Xpress device codec — unit-parallel encode/decode in JAX.

Capability parity: reference ``src/xpress_compress.cpp`` /
``src/xpress_decompress.cpp`` + ``XpressDictionary.h`` (SURVEY.md §2 row 4;
mount unavailable — format per [MS-XCA] §2.3–2.4, SURVEY.md §8.2).

Parallel model: plain Xpress is the one truly sequential format (single
flag/nibble stream, matches reach the whole preceding buffer — SURVEY.md
§5): a foreign single-stream buffer cannot be split.  The device path
therefore operates on batches of INDEPENDENT units (fixed-size segments
produced by this framework's batch/dist API, each a complete valid Xpress
stream; matches confined within the unit).  Foreign one-shot streams take
the sequential oracle/CPU path.  Same data-parallel design as
tpucomp/codecs/lznt1.py: lane-scans + one-shot gathers + sorts; no
scatters.

Decode: a byte-per-step lane-scan (kernels/lane_scan) drives a 14-state
machine per unit
lane (flag-word bytes ×4, token start, match-hi, shared nibble, byte /
u16 / u32 length escapes), emitting a monotone token-record stream; output
bytes bind to records by binary search and copy chains resolve by pointer
doubling.

Encode: shared match kernels (tpucomp.kernels.common) with the 8192-byte
window; after the greedy commit walk the SHARED-NIBBLE state (escape
nibbles pack two-per-byte across tokens; the high nibble of an earlier
token's escape byte belongs to a LATER token) and every byte offset
follow from prefix sums over the committed parse, and the payload is
assembled with monotone placements.
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
    fill_records_delta2,
    greedy_commit,
    place_monotone,
    resolve_copies,
    resolve_copies_wide,
    run_matchlens,
    scatter_sorted_or,
)
from ..kernels.lane_scan import lane_scan

MIN_MATCH = 3
WINDOW = 8192
UNIT = 65536  # default independent-unit size for the batched device path


def max_payload(u: int) -> int:
    """Worst case unit payload: all literals + 1 flag word per 32 + pad."""
    return u + 4 * ((u + 31) // 32) + 8


def max_compressed_size(n: int) -> int:
    return n + 4 * ((n + 31) // 32) + 4


# --------------------------------------------------------------------------
# Decode: 14-state byte-per-step machine
# --------------------------------------------------------------------------

# modes
_M_F0, _M_F1, _M_F2, _M_F3 = 0, 1, 2, 3  # flag word bytes (LE)
_M_TOK = 4  # literal byte or match lo, per current flag bit
_M_HI = 5
_M_NIB = 6
_M_ESC = 7
_M_U16_0, _M_U16_1 = 8, 9
_M_U32_0, _M_U32_1, _M_U32_2, _M_U32_3 = 10, 11, 12, 13

_COPY_BIT = 1 << 20


def make_decoder(u: int, jitter=None, fast_resolve=False):
    """Build a jitted decoder for unit capacity ``u``.

    Args (of the returned function):
      payload: [N, P] int32 unit payload bytes (zero-padded).
      plen:    [N] int32 payload lengths.
      out_len: [N] int32 expected uncompressed length per unit (required:
               the format carries no size header — [MS-XCA] §2.4).
    Returns (out [N, u], err [N]).

    ``jitter``: jit factory (default jax.jit) — dist.ShardedCodec passes
    a mesh-sharded one (batch dim partitioned over ('data',)).
    """
    if u > 65536:
        # decode-tail state encodings (16-bit position planes in
        # fill_records_delta2, 17-bit far-pointer state) cap the unit
        # size; larger buffers must be segmented into <= 64 KiB units.
        raise ArgError("xpress unit_size must be <= 65536")

    def dec(payload, plen, out_len):
        return _decode_impl(payload, plen, out_len, u,
                            fast_resolve=fast_resolve)

    return (jitter or jax.jit)(dec)


# The step body uses int32 0/1 MASKS instead of bools: the mode
# predicates partition active lanes, so selects become masked sums.
def _m(c):
    return c.astype(jnp.int32)


def _sel(mk, a, b):  # mk in {0,1}: mk ? a : b (exact int arithmetic)
    return b + mk * (a - b)


def _parse_step(carry, x, s, consts, take, U):
    """One payload byte of every unit's 14-state machine (lane_scan body)."""
    m, sel = _m, _sel
    (p, mode, flags, nflags, pend_lo, pend_len, nib_have, nib_val,
     rpos, rval, err) = carry
    (b,) = x
    plen, out_len = consts
    active = m(s < plen) * m(p < out_len)

    is_f = active * m(mode <= _M_F3)
    is_tok = active * m(mode == _M_TOK)
    is_hi = active * m(mode == _M_HI)
    is_nib = active * m(mode == _M_NIB)
    is_esc = active * m(mode == _M_ESC)
    is_u16a = active * m(mode == _M_U16_0)
    is_u16b = active * m(mode == _M_U16_1)
    is_u32nd = active * m(mode >= _M_U32_0) * m(mode < _M_U32_3)
    is_u32d = active * m(mode == _M_U32_3)

    # ---- flag word accumulation (LE bytes; consumed MSB-first) ----
    flags = sel(is_f, flags | (b << ((mode & 3) * 8)), flags)
    f_done = active * m(mode == _M_F3)
    nflags = sel(f_done, jnp.int32(32), nflags)

    bit = (flags >> 31) & 1
    is_lit = is_tok * m(bit == 0)
    is_lo = is_tok * m(bit == 1)

    # ---- match hi: offset + short length, maybe complete ----
    tok = pend_lo | (b << 8)
    L0 = tok & 7
    hi_short = is_hi * m(L0 < 7)  # complete now, len = L0 + 3
    hi_esc = is_hi * m(L0 == 7)
    # second nibble use completes (or escalates) without a byte
    use_stored = hi_esc * nib_have
    stored_lt15 = use_stored * m(nib_val < 15)
    stored_esc = use_stored * m(nib_val == 15)
    need_nib = hi_esc * (1 - nib_have)

    # ---- nibble byte ----
    nib_lo = b & 0xF
    nib_done = is_nib * m(nib_lo < 15)
    nib_esc = is_nib * m(nib_lo == 15)

    # ---- escape byte / u16 / u32 ----
    esc_done = is_esc * m(b < 255)
    esc_u16 = is_esc * m(b == 255)
    u16v = pend_len | (b << 8)
    u16_zero = is_u16b * m(u16v == 0)
    u16_done = is_u16b * m(u16v != 0)
    u32v = pend_len | (b << 24)
    u32_done = is_u32d

    # completion paths are mutually exclusive: masked sum
    m_len = (
        hi_short * (L0 + MIN_MATCH)
        + stored_lt15 * (nib_val + 7 + MIN_MATCH)
        + nib_done * (nib_lo + 7 + MIN_MATCH)
        + esc_done * (b + 22 + MIN_MATCH)
        + u16_done * (u16v + MIN_MATCH)
        + u32_done * (u32v + MIN_MATCH)
    )
    m_done = hi_short | stored_lt15 | nib_done | esc_done | u16_done | u32_done
    err = err | (u16_done * m(u16v < 22)) | (u32_done * m(u32v < 22))

    # shared-nibble state: first use stores the high nibble
    nib_have = sel(is_nib, jnp.int32(1), sel(use_stored, jnp.int32(0), nib_have))
    nib_val = sel(is_nib, b >> 4, nib_val)

    # pending offset survives across escape bytes (is_hi stores the
    # full token, so (pend_lo >> 3) + 1 is the offset from then on)
    pend_lo = sel(is_lo, b, sel(is_hi, tok, pend_lo))
    m_off = (pend_lo >> 3) + 1

    pend_len = sel(
        is_u16a | (active * m(mode == _M_U32_0)), b,
        sel(
            active * m(mode == _M_U32_1), pend_len | (b << 8),
            sel(active * m(mode == _M_U32_2), pend_len | (b << 16), pend_len),
        ),
    )

    # ---- records + output advance ----
    err = err | (m_done * (m(m_off > p) | m(p + m_len > out_len)))
    rec_new = is_lit | m_done
    rpos = sel(rec_new, p, rpos)
    rval = sel(is_lit, b, sel(m_done, _COPY_BIT | m_off, rval))
    p = jnp.minimum(p + is_lit + m_done * m_len, U)

    # ---- flag-bit consumption on token completion ----
    flags = sel(rec_new, flags << 1, flags)  # int32 wraps mod 2^32
    nflags = nflags - rec_new

    # ---- next mode: exclusive-mask sum over the partition ----
    mode2 = (
        is_f * sel(f_done, jnp.int32(_M_TOK), mode + 1)
        + is_lit * _M_TOK
        + is_lo * _M_HI
        + need_nib * _M_NIB
        + (stored_esc | nib_esc) * _M_ESC
        + esc_u16 * _M_U16_0
        + is_u16a * _M_U16_1
        + u16_zero * _M_U32_0
        + is_u32nd * (mode + 1)
        + m_done * _M_TOK
        + (1 - active) * mode
    )
    # fresh flag word when the group is exhausted (_M_F0 == 0)
    fresh = rec_new * m(nflags == 0) * m(mode2 == _M_TOK)
    mode2 = mode2 * (1 - fresh)
    flags = flags * m(mode2 != _M_F0)

    return (
        (p, mode2, flags, nflags, pend_lo, pend_len, nib_have, nib_val,
         rpos, rval, err),
        (rpos, rval),
    )


def parse_records(payload, plen, out_len, U, impl=None):
    """Byte-per-step lockstep walk of every unit's token stream.
    Returns (rec_pos [N, P], rec_val [N, P], p_final [N], err [N] int)."""
    N = payload.shape[0]
    z = jnp.zeros(N, jnp.int32)
    init = (z, z, z, z, z, z, z, z, jnp.full((N,), -1, jnp.int32), z, z)
    carry, ys = lane_scan(functools.partial(_parse_step, U=U), init,
                          (payload.T,), consts=(plen, out_len), impl=impl)
    return ys[:, 0, :].T, ys[:, 1, :].T, carry[0], carry[-1]


def _decode_impl(payload, plen, out_len, U, fast_resolve=False, impl=None):
    N = payload.shape[0]
    rec_pos, rec_val, p_final, errk = parse_records(
        payload, plen, out_len, U, impl)
    return _records_to_output(rec_pos, rec_val, p_final, errk, out_len,
                              N, U, fast_resolve=fast_resolve)


def _records_to_output(rec_pos, rec_val, p_final, errk, out_len, N, U,
                       fast_resolve=False):
    """Shared decode tail: monotone token records -> output bytes."""
    j = jnp.broadcast_to(jnp.arange(U, dtype=jnp.int32)[None, :], (N, U))
    vpack, tokpos, _ = fill_records_delta2(rec_pos, rec_val, U)
    err = (errk | (p_final < out_len).astype(jnp.int32)) != 0
    is_copy_j = (vpack & _COPY_BIT) != 0
    disp_j = vpack & (_COPY_BIT - 1)
    # periodic fold (see xpress_huff._records_to_output): overlapping
    # matches copy their own first period — collapses deep far chains
    rel = j - tokpos
    dispc = jnp.maximum(disp_j, 1)
    disp_j = jnp.where(
        is_copy_j & (rel >= dispc), rel - lax.rem(rel, dispc), disp_j)
    litv = jnp.where(is_copy_j, 0, vpack & 0xFF)
    # max_hop = the format's 8 KiB window ([MS-XCA] §2.3): the far
    # rounds can then use overlapped segment tables that contain every
    # parse-emitted source (kernels/common._far_level_overlapped).  OFF
    # by default (it measured slower than the segmented schedule); set
    # TPUCOMP_XP_OVERLAP=1 to re-test it (read at trace time).
    import os as _os

    WIN = (WINDOW if _os.environ.get("TPUCOMP_XP_OVERLAP", "0") == "1"
           else None)
    # full-row probe rounds are OFF for xpress regardless of
    # fast_resolve: the archive profile (overlap model, chain cap 32 —
    # tpucomp_native.c RW_XP_CHAIN_CAP) bounds chains the ADOPTIVE
    # doubling rounds resolve in ceil(log2(32))+1 cond-driven rounds,
    # which depth-2 value-chase probes cannot clear.  Probes are
    # semantics-preserving, so depth-bounded streams still decode
    # bit-exactly on this path.
    del fast_resolve
    if U >= 8192 and U % 16 == 0:
        out = resolve_copies_wide(is_copy_j, disp_j, litv,
                                  fast=False, max_hop=WIN)
    else:
        out = resolve_copies(is_copy_j, disp_j, litv)
    out = jnp.where(j < out_len[:, None], out, 0)
    return out, err


# --------------------------------------------------------------------------
# Encode
# --------------------------------------------------------------------------

_RUN_DISPS = (1, 2, 3)


def make_encoder(u: int, jitter=None):
    if u > 65536:
        raise ArgError("xpress unit_size must be <= 65536")

    def enc(units, ulen):
        return _encode_impl(units, ulen, u)

    return (jitter or jax.jit)(enc)


def _match_extra_sizes(L, opens):
    """Byte cost of a match beyond the 2-byte token, given L = len-3 and
    whether this token opens a fresh nibble byte."""
    nib_user = L >= 7
    rem = jnp.maximum(L - 7, 0)
    rem2 = jnp.maximum(rem - 15, 0)
    sz = jnp.where(nib_user & opens, 1, 0)
    sz = sz + jnp.where(nib_user & (rem >= 15), 1, 0)  # esc byte or 0xFF
    big = nib_user & (rem >= 15) & (rem - 15 >= 255)
    sz = sz + jnp.where(big, 2, 0)  # u16
    sz = sz + jnp.where(big & (L >= 0x10000), 4, 0)  # u32
    return sz, nib_user, rem, big


def _encode_impl(units, ulen, U, impl=None):
    N, n = units.shape
    assert n == U
    pos = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[None, :], (N, n))
    in_len = ulen[:, None]

    # ---- candidates ----
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
                             cap=_CFG.match.cap, max_disp=WINDOW)
    # unbounded exact lengths for cap-saturated matches (the reference
    # scan is uncapped; without this the capped finder loses the multi-
    # KB matches that cover ~12% of the bench corpus)
    hl = extend_saturated(hl, hd, _CFG.match.cap, n)
    consider(hl, hd, hl >= MIN_MATCH)
    if _CFG.match.second_hash_cands:
        h5l, h5d = hash_best_match(
            units, n, hash_bits=_CFG.match.hash_bits,
            num_cands=_CFG.match.second_hash_cands,
            cap=_CFG.match.cap, max_disp=WINDOW, seed=5)
        h5l = extend_saturated(h5l, h5d, _CFG.match.cap, n)
        consider(h5l, h5d, h5l >= MIN_MATCH)

    best_len = jnp.minimum(best_len, in_len - pos)
    is_match = (best_len >= MIN_MATCH) & (pos + MIN_MATCH <= in_len)
    # lazy matching: defer when the next position matches strictly longer
    next_bl = jnp.concatenate(
        [best_len[:, 1:], jnp.zeros((N, 1), jnp.int32)], axis=1
    )
    is_match = is_match & ~(next_bl > best_len)

    # ---- greedy commit (K-unrolled) + closed-form sizes/nibble state ----
    # The shared-nibble pairing is a prefix property: the k-th committed
    # nibble-user opens a fresh nibble byte iff k is even, so parity (and
    # every byte offset) follows from cumsums over the committed parse.
    committed = greedy_commit(is_match, best_len, pos < in_len, impl=impl)
    iscp_pm = committed & is_match
    L_pm = best_len - MIN_MATCH
    nib_user = iscp_pm & (L_pm >= 7)
    nu_cum = jnp.cumsum(nib_user.astype(jnp.int32), axis=1)
    opens_pm = nib_user & (((nu_cum - nib_user.astype(jnp.int32)) & 1) == 0)
    extra_pm, _, _, _ = _match_extra_sizes(L_pm, opens_pm)
    tok_sz = jnp.where(
        iscp_pm, 2 + extra_pm, jnp.where(committed, 1, 0)
    )
    d_cum = jnp.cumsum(tok_sz, axis=1)
    data_before = d_cum - tok_sz
    data_total = d_cum[:, -1]
    t_after = jnp.cumsum(committed.astype(jnp.int32), axis=1)
    T_total = t_after[:, -1]

    # ---- byte assembly: the stream is a partition (each payload byte
    # written exactly once), so the layout is monotone placements — no
    # token-major fills.  Committed position p is
    # token t = t_after[p]-1 in flag group t>>5; its first byte sits at
    # 4*(t>>5 + 1) + data_before[p] (a 4-byte flag word per started
    # group precedes the group's data bytes).
    t_idx = t_after - 1
    grp_p = t_idx >> 5
    off_p = 4 * (grp_p + 1) + data_before
    L_pmv = L_pm
    tokv = jnp.left_shift(best_disp - 1, 3) | jnp.minimum(L_pmv, 7)
    _, _, rem_p, big_p = _match_extra_sizes(L_pmv, opens_pm)
    nibval = jnp.minimum(rem_p, 15)
    b0 = jnp.where(iscp_pm, tokv & 0xFF, units)

    # nibble pairing in nibble-index space (k = nu_cum-1 per user):
    # openers (even k) deposit their low nibble and their nib byte's
    # position; partners (odd k) deposit their nibble at k-1's high
    # half.  All streams are strictly increasing in their key space, so
    # everything assembles with monotone placements (traffic-bound).
    kidx = nu_cum - 1
    is_open = nib_user & opens_pm
    is_part = nib_user & ~opens_pm
    # opener's nib byte sits at its own off+2: deposit off+3 (>=1 so a
    # real position survives the 0=absent convention)
    mlow, mpos1 = place_monotone(
        ~is_open, jnp.where(is_open, kidx, -1), (nibval, off_p + 3), n)
    mhigh = place_monotone(
        ~is_part, jnp.where(is_part, kidx - 1, -1), nibval, n)
    nibbyte_m = mlow | (mhigh << 4)

    # ---- group flag words, assembled in group-index space ----
    NG = n // 32
    gq = jnp.broadcast_to(jnp.arange(NG, dtype=jnp.int32)[None, :], (N, NG))
    fbits = scatter_sorted_or(
        grp_p, jnp.where(iscp_pm, jnp.left_shift(1, 31 - (t_idx & 31)), 0),
        NG)
    ngroups = (T_total + 31) >> 5
    grp_exists = gq < ngroups[:, None]
    # padding bits (absent tokens of the last group) are 1s per the
    # encoder convention: tokens k >= cnt_g occupy stored bits 31-k,
    # i.e. the LOW (32 - cnt_g) bits
    cnt_g = jnp.clip(T_total[:, None] - gq * 32, 0, 32)
    pad_bits = jnp.where(
        cnt_g < 32, jnp.left_shift(1, 32 - cnt_g) - 1, 0)
    fv = fbits | pad_bits
    fpos1 = place_monotone(
        ~(committed & ((t_idx & 31) == 0)), grp_p, off_p - 3,
        NG)  # = flag-word position + 1

    # ---- escape bytes after the 2-byte token:
    #   [nib (if opens)] [esc byte | 0xFF] [u16 lo, hi] [u32 b0..b3]
    esc0 = off_p + 2 + opens_pm.astype(jnp.int32)
    # gate EVERY byte-record predicate on the committed parse:
    # _match_extra_sizes reports big/rem for candidate lengths at ALL
    # positions, committed or not
    has_esc = iscp_pm & (rem_p >= 15)
    has_big = iscp_pm & big_p
    esc_bv = jnp.where(big_p, 255, jnp.maximum(rem_p - 15, 0))
    u16v = jnp.where(L_pmv < 0x10000, L_pmv, 0)
    has_u32 = has_big & (L_pmv >= 0x10000)

    MAXP = max_payload(n)
    bq = jnp.broadcast_to(jnp.arange(MAXP, dtype=jnp.int32)[None, :], (N, MAXP))

    def rolled_or(planes, base=None):
        acc = planes[0] if base is None else base | planes[0]
        for k in range(1, len(planes)):
            acc = acc | jnp.roll(planes[k], k, axis=1)
        return acc

    # token bytes (b0 at off_p; match hi byte at off_p+1 via roll —
    # zero-valued placements from literal tokens OR harmlessly)
    tok_planes = place_monotone(
        ~committed, off_p,
        (jnp.where(committed, b0, 0), jnp.where(iscp_pm, tokv >> 8, 0)),
        MAXP)
    # escape-byte chain anchored at esc0 (strictly increasing among
    # escape users; subset planes carry zeros elsewhere)
    esc_vals = (
        jnp.where(has_esc, esc_bv, 0),
        jnp.where(has_big, u16v & 0xFF, 0),
        jnp.where(has_big, u16v >> 8, 0),
    ) + tuple(
        jnp.where(has_u32, (L_pmv >> (8 * k)) & 0xFF, 0) for k in range(4)
    )
    esc_planes = place_monotone(~has_esc, esc0, esc_vals, MAXP)
    # nibble bytes (positions from m-space) + flag words (group space)
    nib_plane = place_monotone(mpos1 == 0, mpos1 - 1, nibbyte_m, MAXP)
    flag_planes = place_monotone(
        ~grp_exists, fpos1 - 1,
        tuple((fv >> (8 * k)) & 0xFF for k in range(4)), MAXP)
    val = (
        rolled_or(tok_planes)
        | rolled_or(esc_planes)
        | nib_plane
        | rolled_or(flag_planes)
    )

    plen = jnp.where(T_total > 0, 4 * ngroups + data_total, 0)
    payload = jnp.where(bq < plen[:, None], val, 0)
    return payload, plen


# --------------------------------------------------------------------------
# Single-stream encode: ONE [MS-XCA] §2.3 stream over consecutive units
# --------------------------------------------------------------------------
#
# The reference's one-shot encoder (SURVEY.md §2 row 4) compresses a
# whole buffer as one stream with the 8 KiB window rolling across it.
# The per-unit batch above loses that window at every 64 KiB boundary
# (measured +2.3% on the bench slice vs the native one-shot).  This
# variant closes the gap while keeping every lane data-parallel:
#
# * match finding sees the PREVIOUS unit's last 8 KiB as history
#   (sources cross unit boundaries; emitted offsets stay in-window);
# * the flag-word groups (32 tokens), the shared-nibble pairing and
#   every byte offset are computed in GLOBAL stream coordinates via
#   two-level cumsums (per-lane cumsum + exclusive scan over lane
#   totals) — no sequential dependency between lanes;
# * the two true cross-lane couplings — a flag group spanning a lane
#   boundary and a nibble pair split across lanes — are resolved with
#   one segmented suffix-OR over the [N] lane axis and one
#   next-lane-value exchange.
#
# Chunked operation (inputs larger than one dispatch) carries four
# scalars between dispatches (token phase mod 32, nibble parity, the
# last flag word's stream position, a pending nibble-byte position) and
# patches at most 5 already-emitted bytes per boundary on the host.


def _next_from_right(has, val):
    """nxt[i] = val[j] for the SMALLEST j > i with has[j] (0 if none)."""
    h = jnp.flip(has)
    v = jnp.flip(val)

    def comb(a, b):  # inclusive scan, latest set element wins
        return (a[0] | b[0], jnp.where(b[0], b[1], a[1]))

    hh, vv = lax.associative_scan(comb, (h, v))
    ge_h = jnp.flip(hh)
    ge_v = jnp.flip(vv)
    z = jnp.zeros((1,), val.dtype)
    return (
        jnp.concatenate([ge_h[1:], jnp.zeros((1,), bool)]),
        jnp.concatenate([ge_v[1:], z]),
    )


def _encode_stream_impl(units, ulen, hist0, h0v, t0, k0, U):
    """One chunk of the single-stream encoder.

    units[i] are CONSECUTIVE segments of one buffer (all full except
    possibly the last non-empty lane).  ``hist0``/``h0v``: the 8 KiB
    preceding lane 0 (from the previous chunk) and its validity.
    ``t0``: global token count mod 32 before this chunk; ``k0``: global
    nibble-user parity.  Returns per-lane payload planes in chunk-local
    byte coordinates plus the boundary scalars the host carries.
    """
    N, n = units.shape
    assert n == U
    H = WINDOW
    z32 = jnp.int32
    pos = jnp.broadcast_to(jnp.arange(n, dtype=z32)[None, :], (N, n))
    in_len = ulen[:, None]
    lanes = jnp.arange(N, dtype=z32)

    # ---- candidates over history-extended rows ----
    hist = jnp.concatenate([hist0[None, :], units[:-1, -H:]], axis=0)
    xext = jnp.concatenate([hist, units], axis=1)
    hval = ((lanes > 0) | (h0v > 0))[:, None]  # lane's history is real
    pe = jnp.broadcast_to(jnp.arange(H + n, dtype=z32)[None, :], (N, H + n))
    best_len = jnp.zeros((N, H + n), z32)
    best_disp = jnp.ones((N, H + n), z32)

    def consider(length, disp, cond):
        nonlocal best_len, best_disp
        # sources before the stream start are padding, never valid
        ok = cond & (hval | (pe - disp >= H)) & (length > best_len)
        best_len = jnp.where(ok, length, best_len)
        best_disp = jnp.where(ok, disp, best_disp)

    from ..config import DEFAULT as _CFG

    run_disps = _CFG.match.run_disps
    for d, ml in zip(run_disps, run_matchlens(xext, run_disps)):
        consider(ml, jnp.full((N, H + n), d, z32), ml >= MIN_MATCH)
    hl, hd = hash_best_match(xext, H + n, hash_bits=_CFG.match.hash_bits,
                             num_cands=_CFG.match.num_candidates,
                             cap=_CFG.match.cap, max_disp=WINDOW)
    hl = extend_saturated(hl, hd, _CFG.match.cap, H + n)
    consider(hl, hd, hl >= MIN_MATCH)
    if _CFG.match.second_hash_cands:
        h5l, h5d = hash_best_match(
            xext, H + n, hash_bits=_CFG.match.hash_bits,
            num_cands=_CFG.match.second_hash_cands,
            cap=_CFG.match.cap, max_disp=WINDOW, seed=5)
        h5l = extend_saturated(h5l, h5d, _CFG.match.cap, H + n)
        consider(h5l, h5d, h5l >= MIN_MATCH)

    best_len = jnp.minimum(best_len, (H + ulen)[:, None] - pe)
    bl = best_len[:, H:]
    bd = best_disp[:, H:]
    is_match = (bl >= MIN_MATCH) & (pos + MIN_MATCH <= in_len)
    next_bl = jnp.concatenate([bl[:, 1:], jnp.zeros((N, 1), z32)], axis=1)
    is_match = is_match & ~(next_bl > bl)

    committed = greedy_commit(is_match, bl, pos < in_len)
    iscp_pm = committed & is_match
    L_pm = bl - MIN_MATCH

    # ---- global token / nibble / byte coordinates (two-level cumsums)
    nib_user = iscp_pm & (L_pm >= 7)
    nu_inc = jnp.cumsum(nib_user.astype(z32), axis=1)
    nu_tot = nu_inc[:, -1]
    Koff = jnp.cumsum(nu_tot) - nu_tot + k0
    kidx_g = nu_inc - nib_user.astype(z32) + Koff[:, None]
    opens_pm = nib_user & ((kidx_g & 1) == 0)
    extra_pm, _, rem_p, big_p = _match_extra_sizes(L_pm, opens_pm)
    tok_sz = jnp.where(iscp_pm, 2 + extra_pm, jnp.where(committed, 1, 0))
    d_cum = jnp.cumsum(tok_sz, axis=1)
    data_before = d_cum - tok_sz
    dt = d_cum[:, -1]
    Doff = jnp.cumsum(dt) - dt
    t_after = jnp.cumsum(committed.astype(z32), axis=1)
    Tl = t_after[:, -1]
    Toff = jnp.cumsum(Tl) - Tl + t0
    t_g = t_after - 1 + Toff[:, None]
    grp_g = t_g >> 5
    G0w = (t0 + 31) >> 5  # flag words living in PREVIOUS chunks
    off_c = 4 * (grp_g + 1 - G0w) + data_before + Doff[:, None]
    Bv = 4 * ((Toff >> 5) + ((Toff & 31) != 0).astype(z32) - G0w) + Doff
    offl = off_c - Bv[:, None]
    Ttot = Toff[-1] + Tl[-1]
    Ktot = Koff[-1] + nu_tot[-1]
    Bend = (4 * ((Ttot >> 5) + ((Ttot & 31) != 0).astype(z32) - G0w)
            + Doff[-1] + dt[-1])
    plen = jnp.concatenate([Bv[1:], Bend[None]]) - Bv

    # ---- token values ----
    tokv = jnp.left_shift(bd - 1, 3) | jnp.minimum(L_pm, 7)
    nibval = jnp.minimum(rem_p, 15)
    b0 = jnp.where(iscp_pm, tokv & 0xFF, units)

    MAXPG = max_payload(n) + 8
    bq = jnp.broadcast_to(
        jnp.arange(MAXPG, dtype=z32)[None, :], (N, MAXPG))

    def rolled_or(planes, base=None):
        acc = planes[0] if base is None else base | planes[0]
        for k in range(1, len(planes)):
            acc = acc | jnp.roll(planes[k], k, axis=1)
        return acc

    # ---- nibble pairing in GLOBAL pair space (localized per lane) ----
    kpair = kidx_g >> 1
    pl_pair = kpair - (Koff >> 1)[:, None]
    is_open = opens_pm
    is_part = nib_user & ~opens_pm
    PAIRS = n // 2 + 2
    mlow, mpos1 = place_monotone(
        ~is_open, jnp.where(is_open, pl_pair, -1),
        (nibval, offl + 3), PAIRS)
    mhigh = place_monotone(
        ~is_part, jnp.where(is_part, pl_pair, -1), nibval, PAIRS)
    nibbyte_m = mlow | (mhigh << 4)
    nib_plane = place_monotone(mpos1 == 0, mpos1 - 1, nibbyte_m, MAXPG)

    # cross-lane pair: a lane ending on an unpartnered opener receives
    # the NEXT users-lane's first nibble into that byte's high half
    lane_users = nu_tot > 0
    dang_lane = lane_users & (((Koff + nu_tot - 1) & 1) == 0)
    last_user = nib_user & (nu_inc == nu_tot[:, None])
    dang_pos_l = jnp.sum(jnp.where(last_user & is_open, offl + 2, 0),
                         axis=1)
    first_user = nib_user & (nu_inc == 1)
    fval = jnp.sum(jnp.where(first_user, nibval, 0), axis=1)
    nxt_has, nxt_val = _next_from_right(lane_users, fval)
    patch_v = jnp.where(dang_lane & nxt_has, nxt_val << 4, 0)
    nib_patch = jnp.where(bq == dang_pos_l[:, None], patch_v[:, None], 0)
    # boundary scalars: the chunk-global dangling position (last
    # users-lane only) and the chunk's first nibble value
    dangp = jnp.max(jnp.where(dang_lane & ~nxt_has, Bv + dang_pos_l, -1))
    fu_idx = jnp.argmax(lane_users)
    fu_val = fval[fu_idx]
    fu_has = jnp.any(lane_users)

    # ---- flag words in GLOBAL group space (localized per lane) ----
    NGL = n // 32 + 2
    gl = grp_g - (Toff >> 5)[:, None]
    bits = jnp.where(committed & iscp_pm,
                     jnp.left_shift(z32(1), 31 - (t_g & 31)), 0)
    fb_loc = scatter_sorted_or(jnp.where(t_g >= 0, gl, -1), bits, NGL)
    # merge bits of groups that span lane boundaries into the owner
    key = jnp.where(Tl > 0, Toff >> 5, (1 << 28) + lanes)
    head = fb_loc[:, 0]
    contrib = jnp.where((Tl > 0) & ((Toff & 31) != 0), head, 0)

    def comb2(a, b):  # segmented OR (same-key runs are contiguous)
        return (b[0], b[1] | jnp.where(a[0] == b[0], a[1], 0))

    _, sc = lax.associative_scan(
        comb2, (jnp.flip(key), jnp.flip(contrib)))
    acc = jnp.flip(sc)
    accn = jnp.concatenate([acc[1:], jnp.zeros((1,), z32)])
    keyn = jnp.concatenate([key[1:], jnp.full((1,), -7, z32)])
    G_last = jnp.where(Tl > 0, (Toff + Tl - 1) >> 5, -9)
    incoming = jnp.where(keyn == G_last, accn, 0)
    gl_last = jnp.where(Tl > 0, G_last - (Toff >> 5), -1)
    colg = jnp.arange(NGL, dtype=z32)[None, :]
    fb_loc = fb_loc | jnp.where(
        colg == gl_last[:, None], incoming[:, None], 0)
    # bits this chunk contributes to the PREVIOUS chunk's open group
    head0 = jnp.where((t0 & 31) != 0, jnp.where(key[0] == 0, acc[0], 0), 0)
    # NO pad bits here: the host patches the final flag word at flush
    gfirst = committed & ((t_g & 31) == 0) & (t_g >= 0)
    fpos1 = place_monotone(~gfirst, jnp.where(gfirst, gl, -1),
                           offl - 3, NGL)
    flag_planes = place_monotone(
        fpos1 == 0, fpos1 - 1,
        tuple((fb_loc >> (8 * k)) & 0xFF for k in range(4)), MAXPG)
    lastf = jnp.max(jnp.where(gfirst, off_c - 4, -1))

    # ---- escape bytes (identical to the per-unit layout) ----
    esc0 = offl + 2 + opens_pm.astype(z32)
    has_esc = iscp_pm & (rem_p >= 15)
    has_big = iscp_pm & big_p
    esc_bv = jnp.where(big_p, 255, jnp.maximum(rem_p - 15, 0))
    u16v = jnp.where(L_pm < 0x10000, L_pm, 0)
    has_u32 = has_big & (L_pm >= 0x10000)
    tok_planes = place_monotone(
        ~committed, jnp.where(committed, offl, -1),
        (jnp.where(committed, b0, 0), jnp.where(iscp_pm, tokv >> 8, 0)),
        MAXPG)
    esc_vals = (
        jnp.where(has_esc, esc_bv, 0),
        jnp.where(has_big, u16v & 0xFF, 0),
        jnp.where(has_big, u16v >> 8, 0),
    ) + tuple(
        jnp.where(has_u32, (L_pm >> (8 * k)) & 0xFF, 0) for k in range(4)
    )
    esc_planes = place_monotone(
        ~has_esc, jnp.where(has_esc, esc0, -1), esc_vals, MAXPG)
    val = (
        rolled_or(tok_planes)
        | rolled_or(esc_planes)
        | nib_plane
        | nib_patch
        | rolled_or(flag_planes)
    )
    payload = jnp.where(bq < plen[:, None], val, 0)
    return (payload, plen, Ttot, Ktot, head0, lastf, dangp,
            fu_val, fu_has)


def make_stream_encoder(u: int, jitter=None):
    if u > 65536:
        raise ArgError("xpress unit_size must be <= 65536")
    if u < WINDOW:
        # each lane's history is the previous lane's tail; smaller units
        # would need multi-lane history assembly
        raise ArgError("stream encoder needs unit_size >= 8192")

    def enc(units, ulen, hist0, h0v, t0, k0):
        return _encode_stream_impl(units, ulen, hist0, h0v, t0, k0, u)

    return (jitter or jax.jit)(enc)


_SENCODERS = {}


def _senc_for(u, jitter=None):
    from ..config import DEFAULT as _CFG

    # the traced program bakes in trace-time match config — key on its
    # fingerprint so later config changes retrace instead of silently
    # reusing a stale encoder
    key = (u, _jit_key(jitter), _CFG.match.fingerprint())
    if key not in _SENCODERS:
        _SENCODERS[key] = make_stream_encoder(u, jitter)
    return _SENCODERS[key]


def compress_stream(data: bytes, unit_size=UNIT, jitter=None,
                    gather=np.asarray) -> bytes:
    """Compress ``data`` of ANY size into ONE standard [MS-XCA] §2.3
    Xpress stream on device (matches cross unit boundaries through the
    8 KiB window; flag/nibble state threads globally).  Chunked over
    encode_batch_cap-bounded dispatches with host-carried boundary
    state; at most 5 bytes per chunk boundary are patched host-side."""
    data = bytes(data)
    if not data:
        return b""
    U = unit_size
    units_all = [data[i: i + U] for i in range(0, len(data), U)]
    from ..config import DEFAULT as _CFG

    g = 8
    cap = max(g, (_CFG.encode_batch_cap * 65536) // U // g * g)
    enc = _senc_for(U, jitter)
    out = bytearray()
    t_phase = 0
    k_par = 0
    pend_flag = None  # stream offset of the last emitted flag word
    pend_nib = None  # stream offset of an unpartnered nibble byte
    H = WINDOW
    for c0 in range(0, len(units_all), cap):
        chunk = units_all[c0: c0 + cap]
        N = pad_batch(len(chunk), 8)
        ua = np.zeros((N, U), np.int32)
        ul = np.zeros(N, np.int32)
        for i, ud in enumerate(chunk):
            a = np.frombuffer(ud, np.uint8)
            ua[i, : len(a)] = a
            ul[i] = len(a)
        if c0:
            hprev = np.frombuffer(units_all[c0 - 1][-H:], np.uint8)
            h0 = np.zeros(H, np.int32)
            h0[H - len(hprev):] = hprev
            h0v = 1
        else:
            h0 = np.zeros(H, np.int32)
            h0v = 0
        (payload, plen, Ttot, Ktot, head0, lastf, dangp, fu_val,
         fu_has) = enc(jnp.asarray(ua), jnp.asarray(ul), jnp.asarray(h0),
                       jnp.int32(h0v), jnp.int32(t_phase),
                       jnp.int32(k_par))
        payload = gather(payload)
        plen = gather(plen)
        (Ttot, Ktot, head0, lastf, dangp, fu_val, fu_has) = (
            int(Ttot), int(Ktot), int(head0) & 0xFFFFFFFF, int(lastf),
            int(dangp), int(fu_val), bool(fu_has))
        base = len(out)
        if head0 and pend_flag is not None:
            w = int.from_bytes(out[pend_flag: pend_flag + 4], "little")
            out[pend_flag: pend_flag + 4] = (w | head0).to_bytes(
                4, "little")
        if fu_has and pend_nib is not None:
            out[pend_nib] |= (fu_val << 4) & 0xF0
            pend_nib = None
        for i in range(len(chunk)):
            out += payload[i, : int(plen[i])].astype(np.uint8).tobytes()
        if lastf >= 0:
            pend_flag = base + lastf
        if fu_has:  # chunk had nibble users: parity may have flipped
            pend_nib = base + dangp if (Ktot & 1) else None
        t_phase = Ttot & 31
        k_par = Ktot & 1
    if t_phase and pend_flag is not None:
        # final flag word: unused token bits are 1s per the encoder
        # convention ([MS-XCA] §2.4 / SURVEY.md §8.2)
        w = int.from_bytes(out[pend_flag: pend_flag + 4], "little")
        pad = (1 << (32 - t_phase)) - 1
        out[pend_flag: pend_flag + 4] = (w | pad).to_bytes(4, "little")
    return bytes(out)


# --------------------------------------------------------------------------
# Host wrappers: unit-batch bytes API (used by dist + tests)
# --------------------------------------------------------------------------

_ENCODERS = {}
_DECODERS = {}


def _jit_key(jitter):
    return getattr(jitter, "key", None) if jitter is not None else None


def _enc_for(u, jitter=None):
    from ..config import DEFAULT as _CFG

    key = (u, _jit_key(jitter), _CFG.match.fingerprint())
    if key not in _ENCODERS:
        _ENCODERS[key] = make_encoder(u, jitter)
    return _ENCODERS[key]


def _dec_for(u, jitter=None, fast_resolve=False):
    key = (u, _jit_key(jitter), fast_resolve)
    if key not in _DECODERS:
        _DECODERS[key] = make_decoder(u, jitter, fast_resolve=fast_resolve)
    return _DECODERS[key]


def compress_units(units_data, unit_size=UNIT, jitter=None, pad_to=None,
                   gather=np.asarray):
    """Compress a list of byte units (each <= unit_size) in one batch.

    Returns a list of per-unit Xpress streams (each independently
    decodable per [MS-XCA] §2.3).  ``jitter``/``pad_to``/``gather``: see
    dist.ShardedCodec (mesh-sharded jit, device-count batch padding,
    multi-host materialization)."""
    if not units_data:
        return []
    from ..config import DEFAULT as _CFG

    # cap the widest single encode dispatch (config.encode_batch_cap)
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


def decompress_units(streams, out_lens, unit_size=UNIT, jitter=None,
                     pad_to=None, gather=np.asarray, fast_resolve=False):
    """Decompress a batch of independent Xpress unit streams in one
    device call (scan length: the longest stream's; the units run in
    parallel lanes)."""
    if not streams:
        return []
    if any(o > unit_size for o in out_lens):
        raise ArgError("out_len larger than unit_size")
    N = pad_batch(len(streams), pad_to)
    # scan length = padded payload width: the batch's longest stream in
    # 8 KiB steps, not the all-literals worst case
    sizeb = max(1024, -(-max(len(s) for s in streams) // 8192) * 8192)
    P = min(max_payload(unit_size), sizeb + 16)
    payload = np.zeros((N, P), np.int32)
    plen = np.zeros(N, np.int32)
    olen = np.zeros(N, np.int32)
    olen[: len(streams)] = np.asarray(out_lens, np.int32)
    for i, s in enumerate(streams):
        a = np.frombuffer(s, np.uint8)
        payload[i, : len(a)] = a
        plen[i] = len(a)
    out, err = _dec_for(unit_size, jitter, fast_resolve=fast_resolve)(
        jnp.asarray(payload), jnp.asarray(plen), jnp.asarray(olen)
    )
    out = gather(out)
    if gather(err)[: len(streams)].any():
        raise DataError("Xpress: malformed unit stream")
    return [
        out[i, : int(olen[i])].astype(np.uint8).tobytes()
        for i in range(len(streams))
    ]


# --------------------------------------------------------------------------
# One-shot device backend (registered as the "tpu" backend pair)
# --------------------------------------------------------------------------

_ONESHOT_UNITS = (4096, 16384, 65536)


def _oneshot_unit(n: int) -> int:
    for u in _ONESHOT_UNITS:
        if n <= u:
            return u
    from ..errors import UnsupportedFormatError

    # A plain Xpress stream is ONE sequential flag/nibble stream with no
    # discoverable internal boundaries (SURVEY.md §5 long-context note),
    # so one-shot buffers beyond the device unit cap are host work by
    # format design — documented capability boundary, not a bug.
    raise UnsupportedFormatError(
        "XPRESS one-shot 'tpu' backend covers buffers <= 64 KiB (a plain "
        "Xpress stream is a single sequential flag/nibble stream); use "
        "backend='cpu'/'oracle' for larger one-shot buffers, or "
        "compress_units / tpucomp.dist for device-batched segments")


def compress(data: bytes) -> bytes:
    """One-shot plain-Xpress compress on device: ONE standard [MS-XCA]
    §2.3 stream for any input size (<= 64 KiB as a single unit; larger
    via the single-stream chunked encoder with the 8 KiB window rolling
    across unit boundaries).  NOTE: one-shot *decode* of large single
    streams remains host work by format design (see _oneshot_unit /
    decompress) — the stream has no discoverable internal boundaries."""
    data = bytes(data)
    if not data:
        return b""
    if len(data) <= 65536:
        return compress_units([data], unit_size=_oneshot_unit(len(data)))[0]
    return compress_stream(data)


def decompress(data: bytes, out_len=None) -> bytes:
    """One-shot plain-Xpress decompress on device (foreign single
    streams <= 64 KiB; larger raises — see _oneshot_unit)."""
    if out_len is None:
        raise ArgError("Xpress decompression requires out_len")
    if out_len == 0:
        return b""
    return decompress_units(
        [bytes(data)], [out_len], unit_size=_oneshot_unit(out_len))[0]
