"""Unit tests for the shared device kernel primitives."""

import numpy as np
import pytest

import jax.numpy as jnp

from tpucomp.kernels.common import (
    fill_gather,
    fill_gather_left,
    gather_rows,
    resolve_copies,
)


def test_fill_gather_basic():
    keys = jnp.asarray([[1, 3, 3, 7]])
    vals = jnp.asarray([[10, 20, 21, 30]])
    q = jnp.asarray([[0, 1, 2, 3, 4, 7, 9]])
    out = np.asarray(fill_gather(keys, vals, q))[0]
    # last entry with key <= q; ties -> last in original order; miss -> 0
    assert list(out) == [0, 10, 10, 21, 21, 30, 30]


def test_fill_gather_multival():
    keys = jnp.asarray([[2, 5]])
    v1 = jnp.asarray([[100, 200]])
    v2 = jnp.asarray([[7, 9]])
    q = jnp.asarray([[1, 2, 6]])
    o1, o2 = fill_gather(keys, (v1, v2), q)
    assert list(np.asarray(o1)[0]) == [0, 100, 200]
    assert list(np.asarray(o2)[0]) == [0, 7, 9]


def test_fill_gather_left():
    keys = jnp.asarray([[1, 3, 3, 7]])
    vals = jnp.asarray([[10, 20, 21, 30]])
    q = jnp.asarray([[0, 2, 3, 4, 8]])
    out = np.asarray(fill_gather_left(keys, vals, q))[0]
    # first entry with key >= q; ties -> first in original order; miss -> 0
    assert list(out) == [10, 20, 20, 30, 0]


def test_gather_rows_exact(rng):
    data = np.asarray(
        [[rng.randrange(1000) for _ in range(64)] for _ in range(4)], np.int32
    )
    idx = np.asarray(
        [[rng.randrange(64) for _ in range(32)] for _ in range(4)], np.int32
    )
    out = np.asarray(gather_rows(jnp.asarray(data), jnp.asarray(idx)))
    for r in range(4):
        assert (out[r] == data[r][idx[r]]).all()


def test_resolve_copies_rle_and_far():
    # row: 2 literals, a period-2 near copy, then a far copy (d=300)
    U = 512
    is_copy = np.zeros((1, U), bool)
    disp = np.ones((1, U), np.int32)
    litv = np.zeros((1, U), np.int32)
    litv[0, 0] = 65
    litv[0, 1] = 66
    is_copy[0, 2:300] = True
    disp[0, 2:300] = 2  # ABABAB...
    is_copy[0, 300:400] = True
    disp[0, 300:400] = 299  # far copy of [1..101)
    out = np.asarray(
        resolve_copies(
            jnp.asarray(is_copy), jnp.asarray(disp), jnp.asarray(litv), window=64
        )
    )[0]
    expect = [65, 66] * 150
    assert list(out[:300]) == expect[:300]
    assert list(out[300:400]) == list(out[1:101])


def test_resolve_copies_deep_rle():
    # chain depth == length: d=1 run resolves entirely in the window scan
    U = 4096
    is_copy = np.zeros((1, U), bool)
    disp = np.ones((1, U), np.int32)
    litv = np.zeros((1, U), np.int32)
    litv[0, 0] = 77
    is_copy[0, 1:] = True
    out = np.asarray(
        resolve_copies(jnp.asarray(is_copy), jnp.asarray(disp), jnp.asarray(litv))
    )[0]
    assert (out == 77).all()


def test_compact_records_preserves_fill():
    import numpy as np
    import jax.numpy as jnp
    from tpucomp.kernels.common import (
        compact_records, fill_gather, SENT_KEY,
    )

    rng = np.random.default_rng(7)
    N, R, U = 12, 4096, 900
    rp = np.full((N, R), SENT_KEY, np.int32)
    rv = np.zeros((N, R), np.int32)
    for i in range(N):
        k = rng.integers(1, 500)
        # sparse interspersed real records, strictly increasing keys
        cols = np.sort(rng.choice(R, size=k, replace=False))
        ps = np.sort(rng.choice(U, size=k, replace=False))
        rp[i, cols] = ps
        rv[i, cols] = rng.integers(1, 1 << 16, k)
    j = np.broadcast_to(np.arange(U, dtype=np.int32)[None], (N, U))
    want = np.asarray(
        fill_gather(jnp.asarray(rp), jnp.asarray(rv), jnp.asarray(j))
    )
    pc, vc, ovf = compact_records(
        jnp.asarray(rp), jnp.asarray(rv), keep=256, chunk=512, slab=4
    )
    assert pc.shape[1] == (R // 512) * 256
    assert not np.asarray(ovf).any()
    got = np.asarray(fill_gather(pc, vc, jnp.asarray(j)))
    assert np.array_equal(want, got)

    # overflow flags when a chunk holds more real records than keep
    dense = np.arange(R, dtype=np.int32)[None].repeat(2, axis=0)
    pc, vc, ovf = compact_records(
        jnp.asarray(dense), jnp.asarray(dense), keep=100, chunk=512, slab=4
    )
    assert np.asarray(ovf).all()


def _fill_reference(dk, vals, q, reduce=None):
    """numpy fill_gather: per row, the value of the last entry (column
    order) with the largest key <= q; ``reduce="or"`` ORs every entry at
    that key; 0 where no key <= q."""
    out = [np.zeros(q.shape, np.int64) for _ in vals]
    for r in range(q.shape[0]):
        for c, qq in enumerate(q[r]):
            le = dk[r] <= qq
            if not le.any():
                continue
            best = dk[r][le].max()
            at = np.flatnonzero(dk[r] == best)
            for o, v in zip(out, vals):
                o[r, c] = (np.bitwise_or.reduce(v[r][at]) if reduce == "or"
                           else v[r][at[-1]])
    return out


@pytest.mark.parametrize("mode", ["single", "tuple", "or"])
def test_fill_gather_matches_numpy(mode):
    """Duplicate keys, misses and both value forms against numpy."""
    rng = np.random.default_rng(11)
    N, P, U = 5, 300, 200
    dk = rng.integers(0, 400, (N, P)).astype(np.int32)
    v1 = rng.integers(0, 1 << 12, (N, P)).astype(np.int32)
    v2 = rng.integers(0, 1 << 12, (N, P)).astype(np.int32)
    q = rng.integers(-5, 420, (N, U)).astype(np.int32)
    vals = (v1,) if mode == "single" else (v1, v2)
    reduce = "or" if mode == "or" else None
    got = fill_gather(jnp.asarray(dk), jnp.asarray(v1) if mode == "single"
                      else tuple(map(jnp.asarray, vals)), jnp.asarray(q),
                      reduce=reduce)
    got = (got,) if mode == "single" else got
    for g, w in zip(got, _fill_reference(dk, vals, q, reduce)):
        assert np.array_equal(np.asarray(g), w)


def test_resolve_copies_wide_matches_resolve_copies():
    """The 16-positions-per-step near walk resolves exactly like the
    per-position walk (chains of random tokens, overlapping copies)."""
    import numpy as np
    import jax.numpy as jnp
    from tpucomp.kernels.common import resolve_copies, resolve_copies_wide

    rng = np.random.default_rng(23)
    N, U = 6, 2048
    is_copy = np.zeros((N, U), bool)
    disp = np.ones((N, U), np.int32)
    litv = rng.integers(0, 256, (N, U)).astype(np.int32)
    for i in range(N):
        j = 1
        while j < U:
            if rng.random() < 0.5:
                ln = int(rng.integers(3, 40))
                is_copy[i, j : j + ln] = True
                # one disp per token span (overlaps allowed: d < len)
                disp[i, j : j + ln] = int(rng.integers(1, j + 1))
                j += ln
            else:
                j += int(rng.integers(1, 9))
    a = (jnp.asarray(is_copy), jnp.asarray(disp), jnp.asarray(litv))
    want = np.asarray(resolve_copies(*a))
    got = np.asarray(resolve_copies_wide(*a, window=512))
    assert np.array_equal(want, got)


def test_mxu_gather_rows_exact():
    import numpy as np
    import jax.numpy as jnp
    from tpucomp.kernels.common import mxu_gather_rows, FAR_TAG

    rng = np.random.default_rng(31)
    N, K, Q = 5, 1000, 700
    # full int32 range stress incl. tags and negatives
    data = rng.integers(-(1 << 31), 1 << 31, (N, K), dtype=np.int64).astype(
        np.int32
    )
    data[0, :10] = [0, -1, 1, FAR_TAG | 65535, -(1 << 31), (1 << 31) - 1,
                    255, 1 << 28, -12345, 42]
    idx = rng.integers(0, K, (N, Q)).astype(np.int32)
    idx[1, :5] = [-3, K, K + 100, 0, K - 1]  # out-of-range reads 0
    want = np.take_along_axis(data, np.clip(idx, 0, K - 1), axis=1)
    want[(idx < 0) | (idx >= K)] = 0
    got = np.asarray(
        mxu_gather_rows(jnp.asarray(data), jnp.asarray(idx), qchunk=256)
    )
    assert np.array_equal(want, got)


def test_compact_monotone_basic():
    from tpucomp.kernels.common import compact_monotone

    pos = jnp.asarray([[9, 5, 9, 7, 8, 9, 2, 9],
                       [1, 2, 3, 4, 9, 9, 9, 9]])
    val = jnp.asarray([[0, 50, 0, 70, 80, 0, 20, 0],
                       [10, 20, 30, 40, 0, 0, 0, 0]])
    empty = pos == 9
    (cp, cv), valid = compact_monotone(empty, (pos, val))
    assert list(np.asarray(cp)[0][:4]) == [5, 7, 8, 2]
    assert list(np.asarray(cv)[0][:4]) == [50, 70, 80, 20]
    assert list(np.asarray(valid)[0]) == [True] * 4 + [False] * 4
    assert list(np.asarray(cp)[1][:4]) == [1, 2, 3, 4]
    assert list(np.asarray(valid)[1]) == [True] * 4 + [False] * 4


def test_compact_monotone_random():
    from tpucomp.kernels.common import compact_monotone

    g = np.random.default_rng(0xC0FFEE)
    N, R = 5, 777
    empty_np = g.random((N, R)) < 0.8
    vals_np = g.integers(1, 1 << 20, (N, R)).astype(np.int32)
    (cv,), valid = compact_monotone(
        jnp.asarray(empty_np), (jnp.asarray(vals_np),))
    cv, valid = np.asarray(cv), np.asarray(valid)
    for n in range(N):
        want = vals_np[n][~empty_np[n]]
        assert list(cv[n][: len(want)]) == list(want)
        assert valid[n].sum() == len(want)
        assert not valid[n][len(want):].any()
        assert (cv[n][len(want):] == 0).all()


def test_compact_monotone_keep():
    from tpucomp.kernels.common import compact_monotone

    pos = jnp.asarray([[1, 9, 2, 9, 3, 9, 4, 9]])
    (cp,), valid = compact_monotone(pos == 9, (pos,), keep=4)
    assert cp.shape == (1, 4)
    assert list(np.asarray(cp)[0]) == [1, 2, 3, 4]
    assert list(np.asarray(valid)[0]) == [True] * 4


def test_fill_records_delta_matches_fill_gather():
    from tpucomp.kernels.common import fill_records_delta

    g = np.random.default_rng(7)
    N, U = 4, 512
    SENT = 1 << 28
    for trial in range(3):
        rows_pos, rows_val = [], []
        for n in range(N):
            npos = int(g.integers(1, 60))
            pos = np.sort(g.choice(U, npos, replace=False))
            val = g.integers(0, 1 << 21, npos)
            # interleave SENT empties, keep chronological reals
            R = 96
            p = np.full(R, SENT, np.int64)
            v = np.zeros(R, np.int64)
            slots = np.sort(g.choice(R, npos, replace=False))
            p[slots] = pos
            v[slots] = val
            rows_pos.append(p)
            rows_val.append(v)
        rp = jnp.asarray(np.stack(rows_pos).astype(np.int32))
        rv = jnp.asarray(np.stack(rows_val).astype(np.int32))
        got, ovf = fill_records_delta(rp, rv, U)
        got = np.asarray(got)
        assert not np.asarray(ovf).any()
        j = jnp.broadcast_to(jnp.arange(U, dtype=jnp.int32)[None], (N, U))
        want = np.asarray(fill_gather(rp, rv, j))
        assert (got == want).all(), trial


def test_fill_records_delta_duplicates():
    from tpucomp.kernels.common import fill_records_delta

    # duplicate positions: LATER record wins (carry-replicated streams)
    rp = jnp.asarray([[0, 3, 3, 3, 7, -1]])
    rv = jnp.asarray([[5, 10, 11, 12, 900, 0]])
    out = np.asarray(fill_records_delta(rp, rv, 10)[0])[0]
    assert list(out) == [5, 5, 5, 12, 12, 12, 12, 900, 900, 900]


def test_fill_records_delta2_positions_and_overflow():
    from tpucomp.kernels.common import fill_records_delta2

    rp = jnp.asarray([[0, 2, 5, -1, -1, -1]])
    rv = jnp.asarray([[7, 9, 11, 0, 0, 0]])
    vf, pf, ovf = fill_records_delta2(rp, rv, 8)
    assert list(np.asarray(vf)[0]) == [7, 7, 9, 9, 9, 11, 11, 11]
    assert list(np.asarray(pf)[0]) == [0, 0, 2, 2, 2, 5, 5, 5]
    assert not np.asarray(ovf).any()
    # keep bound violated -> overflow flagged
    _, _, ovf = fill_records_delta2(rp, rv, 8, keep=2)
    assert np.asarray(ovf).all()


def test_scatter_add_matmul():
    from tpucomp.kernels.common import scatter_add_matmul

    g = np.random.default_rng(3)
    N, R, U = 3, 500, 640
    pos = g.integers(-5, U + 5, (N, R)).astype(np.int32)
    val = g.integers(0, 1 << 16, (N, R)).astype(np.int32)
    got = np.asarray(scatter_add_matmul(
        jnp.asarray(pos), jnp.asarray(val), U, nbits=16))
    want = np.zeros((N, U), np.int64)
    for n in range(N):
        for i in range(R):
            if 0 <= pos[n, i] < U:
                want[n, pos[n, i]] += val[n, i]
    assert (got == want).all()


def test_histogram_matmul():
    from tpucomp.kernels.common import histogram_matmul

    g = np.random.default_rng(4)
    N, n, B = 3, 3000, 512
    sym = g.integers(0, B + 1, (N, n)).astype(np.int32)  # B = sentinel
    got = np.asarray(histogram_matmul(jnp.asarray(sym), B))
    for k in range(N):
        want = np.bincount(sym[k][sym[k] < B], minlength=B)
        assert (got[k] == want).all()


def test_expand_monotone_roundtrip():
    from tpucomp.kernels.common import compact_monotone, expand_monotone

    g = np.random.default_rng(11)
    N, R = 4, 300
    empty_np = g.random((N, R)) < 0.7
    vals_np = g.integers(1, 1 << 20, (N, R)).astype(np.int32)
    pos_np = np.broadcast_to(np.arange(R, dtype=np.int32), (N, R)).copy()
    (cv, cp), valid = compact_monotone(
        jnp.asarray(empty_np), (jnp.asarray(vals_np), jnp.asarray(pos_np)))
    iota = jnp.arange(R, dtype=jnp.int32)[None, :]
    (ev,), placed = expand_monotone(~valid, (cv,), cp - iota, R)
    ev, placed = np.asarray(ev), np.asarray(placed)
    for n in range(N):
        want_mask = ~empty_np[n]
        assert (placed[n] == want_mask).all()
        assert (ev[n][want_mask] == vals_np[n][want_mask]).all()
        assert (ev[n][~want_mask] == 0).all()


def test_far_rounds_property():
    from tpucomp.kernels.common import FAR_TAG, _far_rounds

    # random valid chain structure: each position is a literal or a
    # far pointer strictly earlier; expected = chase to the literal
    g = np.random.default_rng(12)
    N, U = 2, 16384
    out = np.zeros((N, U), np.int64)
    for n in range(N):
        out[n, 0] = g.integers(0, 256)
        for j in range(1, U):
            if g.random() < 0.4:
                out[n, j] = FAR_TAG | int(g.integers(0, j))
            else:
                out[n, j] = g.integers(0, 256)
    got = np.asarray(_far_rounds(
        jnp.asarray(out.astype(np.int32)), U, 512))
    want = np.zeros((N, U), np.int64)
    for n in range(N):
        for j in range(U):
            v = out[n, j]
            while v & FAR_TAG:
                v = out[n, v & (FAR_TAG - 1)]
            want[n, j] = v
    assert (got == want).all()


def test_far_rounds_compacted_final_level():
    from tpucomp.kernels.common import FAR_TAG, _far_rounds

    # U > 16384 exercises _far_final_compacted; tag counts above its
    # per-round `keep` (U//8 = 4096) exercise the multi-round path.
    g = np.random.default_rng(3)
    N, U = 2, 32768
    out = g.integers(0, 256, (N, U)).astype(np.int64)
    for n in range(N):
        idx = np.sort(g.choice(np.arange(600, U), 9000, replace=False))
        for j in idx:
            out[n, j] = FAR_TAG | int(g.integers(0, j - 520))
    got = np.asarray(_far_rounds(
        jnp.asarray(out.astype(np.int32)), U, 512))
    want = out.copy()
    for n in range(N):
        for j in range(U):  # ascending: sources already resolved
            if want[n, j] & FAR_TAG:
                want[n, j] = want[n, want[n, j] & (FAR_TAG - 1)]
    assert (got == want).all()


def test_mxu_gather_rows_wide_table(rng):
    """One-hot gather over a table wider than 16 K entries == numpy
    take, out-of-range indices reading 0."""
    import numpy as np

    from tpucomp.kernels.common import mxu_gather_rows

    N, K, Q = 3, 16384 + 77, 1500
    data = np.array(
        [[rng.randrange(1 << 18) for _ in range(K)] for _ in range(N)],
        np.int32)
    idx = np.array(
        [[rng.randrange(-5, K + 200) for _ in range(Q)] for _ in range(N)],
        np.int32)
    got = np.asarray(mxu_gather_rows(jnp.asarray(data), jnp.asarray(idx),
                                      nbits=18))
    ok = (idx >= 0) & (idx < K)
    want = np.where(ok, data[np.arange(N)[:, None], np.clip(idx, 0, K - 1)],
                    0)
    assert (got == want).all()


def test_hash_best_match_equals_unfused(rng):
    """hash_best_match == hash_candidates + multi_matchlens + max-merge
    (same candidates, lengths, tie-breaks)."""
    import numpy as np

    from tpucomp.kernels.common import (
        hash_best_match, hash_candidates, le_words, multi_matchlens)

    N, n = 4, 2048
    base = bytes(rng.randrange(4) for _ in range(n))  # match-heavy
    x = np.frombuffer((base * N)[: N * n], np.uint8).astype(np.int32)
    x = x.reshape(N, n)
    xd = jnp.asarray(x)
    for max_disp in (None, 512):
        bl, bd = hash_best_match(xd, n, hash_bits=11, num_cands=3, cap=16,
                                 max_disp=max_disp)
        w = le_words(xd)
        pos = jnp.arange(n, dtype=jnp.int32)[None, :]
        cands = hash_candidates(xd, hash_bits=11, num_cands=3)
        valids = [c >= 0 if max_disp is None else ((c >= 0) & (pos - c <= max_disp))
                  for c in cands]
        mls = multi_matchlens(w, cands, valids, n, cap=16)
        ebl = jnp.zeros((N, n), jnp.int32)
        ebd = jnp.ones((N, n), jnp.int32)
        for c, v, ml in zip(cands, valids, mls):
            mlv = jnp.where(v, ml, 0)
            better = v & (mlv > ebl)
            ebl = jnp.where(better, mlv, ebl)
            ebd = jnp.where(better, pos - c, ebd)
        assert (np.asarray(bl) == np.asarray(ebl)).all(), max_disp
        sel = np.asarray(ebl) > 0
        assert (np.asarray(bd)[sel] == np.asarray(ebd)[sel]).all(), max_disp


@pytest.mark.parametrize("N,U", [(3, 256), (9, 1024), (40, 65536)])
def test_sort_rows_matches_lax_sort(N, U):
    """sort_rows == one lax.sort: ascending by a UNIQUE key, payload
    planes permuted along."""
    import jax.numpy as jnp
    from jax import lax

    from tpucomp.kernels.common import sort_rows

    rng = np.random.default_rng(11)
    key = np.stack([rng.permutation(U) for _ in range(N)]).astype(
        np.int32) * 5 - 7  # unique, some negative
    pay = rng.integers(-2**31, 2**31 - 1, (N, U), dtype=np.int32)
    ref = lax.sort((jnp.asarray(key), jnp.asarray(pay)),
                   dimension=1, num_keys=1)
    got = sort_rows((jnp.asarray(key), jnp.asarray(pay)))
    for r, g in zip(ref, got):
        assert (np.asarray(r) == np.asarray(g)).all()


def test_gather18_reference():
    """The far levels' 18-bit pointer fetch against numpy, including
    out-of-range indices."""
    import jax.numpy as jnp

    from tpucomp.kernels.common import _gather18

    rng = np.random.default_rng(12)
    N, K, Q = 3, 900, 300
    data = rng.integers(0, 1 << 18, (N, K), dtype=np.int32)
    idx = rng.integers(-4, K + 4, (N, Q), dtype=np.int32)
    ok = (idx >= 0) & (idx < K)
    want = np.where(
        ok, data[np.arange(N)[:, None], np.clip(idx, 0, K - 1)], 0)
    got = _gather18(jnp.asarray(data), jnp.asarray(idx))
    assert (np.asarray(got) == want).all()


def test_run_matchlens_reference():
    """The log-depth run matcher against a per-position numpy walk."""
    import jax.numpy as jnp

    from tpucomp.kernels.common import run_matchlens

    rng = np.random.default_rng(13)
    x = rng.integers(0, 4, (5, 512), dtype=np.int32)
    x[1] = 7  # constant row: maximal runs
    outs = run_matchlens(jnp.asarray(x), (1, 2, 3))
    # reference: per-position leading-ones of x[q] == x[q-d]
    for d, got in zip((1, 2, 3), outs):
        eq = np.zeros_like(x)
        eq[:, d:] = x[:, d:] == x[:, :-d]
        exp = np.zeros_like(x)
        for n in range(x.shape[0]):
            run = 0
            for p in range(x.shape[1] - 1, -1, -1):
                run = run + 1 if eq[n, p] else 0
                exp[n, p] = run
        assert (np.asarray(got) == exp).all(), d


def test_far_probe_round_reference():
    """One value-chase probe round against numpy: a tag whose target is
    final takes the target's byte; a tag on a live target stays."""
    import jax.numpy as jnp

    from tpucomp.kernels.common import FAR_TAG, _far_probe_round

    rng = np.random.default_rng(13)
    N, U = 5, 700
    out = rng.integers(0, 256, (N, U), dtype=np.int32)
    tagged = rng.random((N, U)) < 0.4
    src = rng.integers(0, U, (N, U), dtype=np.int32)
    out = np.where(tagged, FAR_TAG | src, out)
    got = np.asarray(_far_probe_round(jnp.asarray(out), U))
    tgt = out[np.arange(N)[:, None], src]
    want = np.where(tagged & ((tgt & FAR_TAG) == 0), tgt & 0xFF, out)
    assert (got == want).all()
