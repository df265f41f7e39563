"""LZNT1 device codec — chunk-parallel encode/decode in JAX.

Capability parity: reference ``src/lznt1_compress.cpp`` /
``src/lznt1_decompress.cpp`` + ``LZNT1Dictionary.h`` (SURVEY.md §2 rows 3,
7; mount unavailable — format per [MS-XCA] §2.5, SURVEY.md §8.1).

The design is data-parallel over chunks and scatter-free (it was first
built for a machine without hardware scatter; ROADMAP §3.1/§3.3 revisit
that on the GPU).  Every stage is built from lane-scans, rolls, one-shot
gathers, row-wise binary search and a few XLA sorts:

* Decode: a byte-per-step lockstep walk (kernels/lane_scan: one Triton
  kernel on the GPU, ``lax.scan`` elsewhere) steps all chunks' token
  streams simultaneously (uniform step index ⇒ the payload byte arrives
  as a step operand, not a gather).  It emits a monotone record stream
  (token start position + literal byte / copy displacement, with carry
  replication on idle steps).  Each output byte then finds its governing
  token by binary search, and copy chains resolve in O(log 4096) rounds
  of pointer doubling (``ptr = ptr[ptr]``) — copies are never expanded
  byte-at-a-time.
* Encode: match candidates from (a) exact run-length matchers for small
  displacements (reverse scan) and (b) a sort-based positional hash table
  (sort (hash,pos) with carried positions; neighbors in sort order are
  the most recent same-hash candidates; a second sort restores position
  order — the scatter-free inverse permutation).  Greedy parse commits in
  one forward cursor walk; the token/flag-byte layout follows from
  prefix sums and monotone placements.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..errors import DataError
from ..kernels.lane_scan import lane_scan
from ..kernels.common import (
    extend_saturated,
    greedy_commit,
    hash_best_match,
    fill_records_delta,
    place_monotone,
    resolve_copies,
    run_matchlens,
    scatter_sorted_or,
)

CHUNK = 4096
MIN_MATCH = 3
# Compressed payload bound: 4096 literals + 512 flag bytes.
MAX_PAYLOAD = CHUNK + CHUNK // 8
# Input payload pad (scan length; also covers raw chunks).
PAYLOAD_PAD = MAX_PAYLOAD + 8


def _dsplit(p):
    """Vectorized LZNT1 (l_mask, d_shift) for output position(s) ``p``.

    Spec loop ``q=p-1; while q>=0x10: shift`` ≡ ``s = max(0, bitlen(q)-4)``.
    """
    q = jnp.maximum(p - 1, 0)
    bl = 32 - lax.clz(q.astype(jnp.int32))
    s = jnp.maximum(bl - 4, 0)
    d_shift = 12 - s
    l_mask = jnp.left_shift(1, d_shift) - 1
    return l_mask, d_shift


# Static per-position split tables.
_POS = np.arange(CHUNK)
_Q = np.maximum(_POS - 1, 0)
_BL = np.zeros(CHUNK, np.int32)
for _b in range(13):
    _BL[_Q >= (1 << _b)] = _b + 1
_SHIFTS = np.maximum(_BL - 4, 0)
L_MASK_TABLE = ((1 << (12 - _SHIFTS)) - 1).astype(np.int32)  # max len-3 at pos
D_SHIFT_TABLE = (12 - _SHIFTS).astype(np.int32)


# --------------------------------------------------------------------------
# Decode
# --------------------------------------------------------------------------

_COPY_BIT = 1 << 20  # record-value flag: copy record (else literal byte)


def _mk(c):
    return c.astype(jnp.int32)


def _parse_step(carry, x, s, consts, take):
    """One payload byte of every chunk's token walk (lane_scan body).

    Emits a monotone record stream: token start position + literal byte
    / copy displacement, carry-replicated on idle steps."""
    p, flags, nflags, expect_hi, pend_lo, rpos, rval, err = carry
    (b,) = x
    plen, is_comp = consts
    active = (is_comp != 0) & (s < plen) & (p < CHUNK)
    expect = expect_hi != 0
    start_flag = active & ~expect & (nflags == 0)
    in_tok = active & ~start_flag
    bit = (flags & 1) != 0
    is_lit = in_tok & ~expect & ~bit
    is_lo = in_tok & ~expect & bit
    is_hi = in_tok & expect
    tok = pend_lo | (b << 8)
    l_mask, d_shift = _dsplit(p)
    length = (tok & l_mask) + MIN_MATCH
    disp = (tok >> d_shift) + 1
    err = err | _mk(is_hi & ((disp > p) | (p + length > CHUNK)))
    rpos = jnp.where(is_lit | is_hi, p, rpos)
    rval = jnp.where(is_lit, b, jnp.where(is_hi, _COPY_BIT | disp, rval))
    p = p + jnp.where(
        is_lit, 1, jnp.where(is_hi, jnp.minimum(length, CHUNK - p), 0))
    flags = jnp.where(
        start_flag, b, jnp.where(is_lit | is_lo, flags >> 1, flags))
    nflags = jnp.where(
        start_flag, 8, jnp.where(is_lit | is_lo, nflags - 1, nflags))
    pend_lo = jnp.where(is_lo, b, pend_lo)
    expect_hi = jnp.where(is_lo, 1, jnp.where(is_hi, 0, expect_hi))
    return (p, flags, nflags, expect_hi, pend_lo, rpos, rval, err), (
        rpos, rval)


def parse_records(payload, plen, is_comp, impl=None):
    """Byte-per-step lockstep walk of all chunks' token streams (uniform
    step index, so each payload byte arrives as a step operand, not a
    gather).  Returns (rec_pos [N, P], rec_val [N, P], p_final [N],
    err [N] bool)."""
    N, P = payload.shape
    z = jnp.zeros(N, jnp.int32)
    init = (z, z, z, z, z, jnp.full((N,), -1, jnp.int32), z, z)
    carry, ys = lane_scan(_parse_step, init, (payload.T,),
                          consts=(plen, is_comp.astype(jnp.int32)),
                          impl=impl)
    p_final, expect_hi_f, err = carry[0], carry[3], carry[7]
    err = (err != 0) | (is_comp & (expect_hi_f != 0))  # ended mid-token
    return ys[:, 0, :].T, ys[:, 1, :].T, p_final, err


def decode_batch_impl(payload, plen, is_comp, impl=None):
    """Decode a batch of LZNT1 chunk payloads (headers already stripped).

    Args:
      payload: [N, PAYLOAD_PAD] int32 — per-chunk payload bytes, zero-padded.
      plen:    [N] int32 — true payload byte length.
      is_comp: [N] bool — compressed flag from each chunk header.
      impl:    lane_scan implementation (None: chosen by platform).

    Returns:
      out:     [N, CHUNK] int32 decoded bytes
      out_len: [N] int32 decoded length per chunk
      err:     [N] bool malformed-stream flag
    """
    N = payload.shape[0]
    rec_pos, rec_val, p_final, err = parse_records(
        payload, plen, is_comp, impl)
    return _records_to_output(
        rec_pos, rec_val, p_final, err, payload, plen, is_comp, N)


decode_batch = jax.jit(decode_batch_impl, static_argnames="impl")


def _records_to_output(rec_pos, rec_val, p_final, err, payload, plen,
                       is_comp, N):
    """Shared decode tail: token records -> output bytes."""
    # --- records -> dense per-output-position token info (sort fill) ---
    j = jnp.broadcast_to(jnp.arange(CHUNK, dtype=jnp.int32)[None, :], (N, CHUNK))
    vpack, _ = fill_records_delta(rec_pos, rec_val, CHUNK)
    is_copy_j = (vpack & _COPY_BIT) != 0
    disp_j = vpack & (_COPY_BIT - 1)
    litv = jnp.where(is_copy_j, 0, vpack & 0xFF)

    # --- copy-chain resolution (near-window scan + far rounds) ---
    out_comp = resolve_copies(is_copy_j, disp_j, litv)

    out = jnp.where(is_comp[:, None], out_comp, payload[:, :CHUNK])
    out_len = jnp.where(is_comp, p_final, jnp.minimum(plen, CHUNK))
    out = jnp.where(j < out_len[:, None], out, 0)
    return out, out_len, err


# --------------------------------------------------------------------------
# Encode
# --------------------------------------------------------------------------

_RUN_DISPS = (1, 2, 3)  # exact-length small displacements (RLE, periods)


def encode_batch_impl(chunks, clen, impl=None):
    """Encode a batch of ≤4096-byte chunks into LZNT1 token payloads.

    Args:
      chunks: [N, CHUNK] int32 — chunk bytes, zero-padded.
      clen:   [N] int32 — true chunk length.

    Returns:
      payload: [N, MAX_PAYLOAD] int32 token/flag bytes
      plen:    [N] int32 payload length (host applies the stored-raw
               fallback when plen >= clen)
    """
    N, n = chunks.shape
    pos = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[None, :], (N, n))
    in_len = clen[:, None]
    l_mask = jnp.asarray(L_MASK_TABLE)[None, :]
    d_shift = jnp.asarray(D_SHIFT_TABLE)[None, :]

    # ---- candidate scoring ----
    best_len = jnp.zeros((N, n), jnp.int32)
    best_disp = jnp.ones((N, n), jnp.int32)

    def consider(length, disp, cond):
        nonlocal best_len, best_disp
        better = cond & (length > best_len)
        best_len = jnp.where(better, length, best_len)
        best_disp = jnp.where(better, disp, best_disp)

    # exact small-displacement runs via ONE reverse scan (3 operands);
    # effort knobs from tpucomp.config (read at trace time)
    from ..config import DEFAULT as _CFG

    run_disps = _CFG.match.run_disps
    for d, ml in zip(run_disps, run_matchlens(chunks, run_disps)):
        consider(ml, jnp.full((N, n), d, jnp.int32), ml >= MIN_MATCH)

    # hash candidates scored by capped word-compare, fused in sort
    # order (hash_best_match: no separate fill_gather)
    hl, hd = hash_best_match(chunks, n, pos_bits=12,
                             hash_bits=_CFG.match.hash_bits,
                             num_cands=_CFG.match.num_candidates,
                             cap=_CFG.match.cap)
    # unbounded exact lengths for cap-saturated matches (the reference
    # scan is uncapped; without this the capped finder loses the multi-
    # KB matches that cover ~12% of the bench corpus)
    hl = extend_saturated(hl, hd, _CFG.match.cap, n)
    consider(hl, hd, hl >= MIN_MATCH)

    # clip to format + chunk limits
    max_here = jnp.minimum(l_mask + MIN_MATCH, in_len - pos)
    best_len = jnp.minimum(best_len, max_here)
    is_match = (best_len >= MIN_MATCH) & (pos + MIN_MATCH <= in_len)

    # ---- greedy commit (lane-scan cursor walk) + layout prefix sums ----
    # Lazy matching: defer a match when the NEXT position has a strictly
    # longer one (standard 1-step lazy heuristic; still a valid parse).
    next_bl = jnp.concatenate(
        [best_len[:, 1:], jnp.zeros((N, 1), jnp.int32)], axis=1
    )
    use_match = is_match & ~(next_bl > best_len)
    committed = greedy_commit(use_match, best_len, pos < in_len, impl=impl)
    tok_sz = jnp.where(committed & use_match, 2, committed.astype(jnp.int32))
    t_after = jnp.cumsum(committed.astype(jnp.int32), axis=1)
    d_cum = jnp.cumsum(tok_sz, axis=1)
    data_before = d_cum - tok_sz
    T_total = t_after[:, -1]
    data_total = d_cum[:, -1]

    # ---- byte assembly: the stream is a partition (each payload byte
    # written exactly once) and every record stream is sorted by its
    # target position, so the whole layout is monotone placements
    # (compact+expand log-depth passes — see kernels.common).
    # Committed position p is token t = t_after[p]-1 in group t>>3; its
    # first byte sits at (t>>3 + 1) + data_before[p] (one flag byte per
    # started group precedes the group's data bytes).
    t_idx = t_after - 1
    grp_p = t_idx >> 3
    off_p = grp_p + 1 + data_before
    iscp_p = committed & use_match
    tokv = jnp.left_shift(best_disp - 1, jnp.broadcast_to(d_shift, (N, n))
                          ) | (best_len - MIN_MATCH)
    b0 = jnp.where(iscp_p, tokv & 0xFF, chunks)

    # group flag bytes, assembled in group-index space: copy tokens
    # OR their bit per group (grp_p is non-decreasing: segmented OR);
    # each group's FIRST token places the group's flag-byte position
    # (+1 so a real position 0 survives the 0=empty convention)
    NG = n // 8
    gq = jnp.broadcast_to(jnp.arange(NG, dtype=jnp.int32)[None, :], (N, NG))
    fval = scatter_sorted_or(
        grp_p, jnp.where(iscp_p, jnp.left_shift(1, t_idx & 7), 0), NG)
    fpos1 = place_monotone(
        ~(committed & ((t_idx & 7) == 0)), grp_p, off_p, NG)
    ngroups = (T_total + 7) >> 3
    grp_exists = gq < ngroups[:, None]

    MAXQ = MAX_PAYLOAD
    bq = jnp.broadcast_to(
        jnp.arange(MAXQ, dtype=jnp.int32)[None, :], (N, MAXQ)
    )
    d_b0, d_hi = place_monotone(
        ~committed, off_p,
        (jnp.where(committed, b0, 0), jnp.where(iscp_p, tokv >> 8, 0)),
        MAXQ)
    d_fl = place_monotone(
        ~grp_exists, fpos1 - 1, jnp.where(grp_exists, fval, 0), MAXQ)
    val = d_b0 | jnp.roll(d_hi, 1, axis=1) | d_fl
    plen = jnp.where(T_total > 0, ngroups + data_total, 0)
    payload = jnp.where(bq < plen[:, None], val, 0)
    return payload, plen


encode_batch = jax.jit(encode_batch_impl, static_argnames="impl")


# --------------------------------------------------------------------------
# Host wrappers (bytes <-> batches), registered as the "tpu" backend
# --------------------------------------------------------------------------


def split_stream(data: bytes):
    """Sequential header scan of an LZNT1 stream → per-chunk payload table.

    O(#chunks) host work; foreign streams only.  Batch jobs produced by
    this codec keep a manifest instead (tpucomp.dist) and skip the scan.
    """
    payloads, comps = [], []
    i, nb = 0, len(data)
    while i + 2 <= nb:
        header = data[i] | (data[i + 1] << 8)
        i += 2
        if header == 0:
            break
        size = (header & 0xFFF) + 1
        if i + size > nb:
            raise DataError("LZNT1: chunk payload extends past end of input")
        payloads.append(data[i : i + size])
        comps.append(bool(header & 0x8000))
        i += size
    return payloads, comps


from ..util import pad_batch as _pad_batch  # noqa: E402


def decompress(data: bytes, out_len=None) -> bytes:
    """One-shot LZNT1 decode on device (chunk-parallel)."""
    data = bytes(data)
    if not data:
        return b""
    payloads, comps = split_stream(data)
    if not payloads:
        return b""
    N = _pad_batch(len(payloads))
    payload = np.zeros((N, PAYLOAD_PAD), np.int32)
    plen = np.zeros(N, np.int32)
    is_comp = np.zeros(N, bool)
    for k, (pl, cp) in enumerate(zip(payloads, comps)):
        a = np.frombuffer(pl, np.uint8)
        payload[k, : len(a)] = a
        plen[k] = len(a)
        is_comp[k] = cp
    out, out_lens, err = decode_batch(
        jnp.asarray(payload), jnp.asarray(plen), jnp.asarray(is_comp)
    )
    out = np.asarray(out)
    out_lens = np.asarray(out_lens)
    if np.asarray(err)[: len(payloads)].any():
        raise DataError("LZNT1: malformed stream")
    parts = [
        out[i, : int(out_lens[i])].astype(np.uint8).tobytes()
        for i in range(len(payloads))
    ]
    result = b"".join(parts)
    if out_len is not None:
        if len(result) < out_len:
            raise DataError("LZNT1: stream ended before out_len bytes")
        result = result[:out_len]
    return result


def compress(data: bytes) -> bytes:
    """One-shot LZNT1 encode on device (chunk-parallel, stored-raw fallback)."""
    data = bytes(data)
    if not data:
        return b""
    nchunks = -(-len(data) // CHUNK)
    N = _pad_batch(nchunks)
    chunks = np.zeros((N, CHUNK), np.int32)
    clen = np.zeros(N, np.int32)
    arr = np.frombuffer(data, np.uint8)
    flat = chunks[:nchunks].reshape(-1)
    flat[: len(arr)] = arr
    chunks[:nchunks] = flat.reshape(nchunks, CHUNK)
    clen[:nchunks] = np.minimum(len(arr) - np.arange(nchunks) * CHUNK, CHUNK)
    payload, plen = encode_batch(jnp.asarray(chunks), jnp.asarray(clen))
    payload = np.asarray(payload)
    plen = np.asarray(plen)
    out = bytearray()
    for k in range(nchunks):
        pl = int(plen[k])
        cl = int(clen[k])
        if pl < cl:
            header = 0xB000 | (pl - 1)
            out += header.to_bytes(2, "little")
            out += payload[k, :pl].astype(np.uint8).tobytes()
        else:
            header = 0x3000 | (cl - 1)
            out += header.to_bytes(2, "little")
            out += data[k * CHUNK : k * CHUNK + cl]
    return bytes(out)


def max_compressed_size(n: int) -> int:
    nchunks = (n + CHUNK - 1) // CHUNK
    return n + 2 * max(nchunks, 1) + 2
