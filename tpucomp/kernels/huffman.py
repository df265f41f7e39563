"""Batched canonical Huffman construction on device (no gathers/scatters).

Reference parity: ``include/mscomp/HuffmanEncoder.h`` /
``HuffmanDecoder.h`` (SURVEY.md §2 row 8; mount unavailable).  The oracle
uses optimal package-merge; this device kernel builds true Huffman depths
(two-queue merge) and applies the classic deflate-style overflow repair
to the 15-bit limit — equal or near-equal code cost in practice, always a
valid prefix code.

Data-parallel form (see tpucomp/codecs/lznt1.py):
* the two-queue merge is one 511-step lockstep scan; queue reads are
  one-hot selects over the small [N, 512] node array (cheap at this size)
* node depths: reverse scan; parent depth read again via small one-hot
* leaf depths / symbol assignment: lax.sort + prefix sums
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from .common import sort_rows

NUM_SYMBOLS = 512
MAX_CODE_LEN = 15
_INF = 1 << 30


def huffman_code_lengths(freqs):
    """freqs: [N, 512] int32 -> code lengths [N, 512] (0 = unused), <= 15.

    Rows with <= 1 used symbol get a single 1-bit code (matching the
    oracle's convention).
    """
    N, S = freqs.shape
    used = freqs > 0
    n_used = jnp.sum(used.astype(jnp.int32), axis=1)

    # ---- leaves sorted by (freq, sym); unused sink to the end ----
    key = jnp.where(used, freqs, _INF)
    leaf_freq, leaf_sym = sort_rows(
        (key, jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (N, S)).copy()),
        num_keys=1,
    )

    # ---- two-queue Huffman merge: 511 lockstep steps ----
    # carry: leaf pointer, node queue head, node freq array, counts
    NN = S  # max internal nodes = S - 1
    iota_nn = jnp.arange(NN, dtype=jnp.int32)[None, :]

    def sel(arr, idx):
        """arr [N, NN] one-hot select at per-row idx (small table)."""
        oh = idx[:, None] == iota_nn
        return jnp.sum(jnp.where(oh, arr, 0), axis=1)

    def leaf_at(idx):
        oh = idx[:, None] == iota_nn
        return jnp.sum(jnp.where(oh, leaf_freq, 0), axis=1)

    def step(carry, s):
        lp, nh, node_freq, err = carry
        created = s < jnp.maximum(n_used - 1, 0)
        # candidate costs: two cheapest among (leaf lp, leaf lp+1,
        # node nh, node nh+1) respecting queue bounds
        lf0 = jnp.where(lp < S, leaf_at(lp), _INF)
        lf1 = jnp.where(lp + 1 < S, leaf_at(lp + 1), _INF)
        nf0 = jnp.where(nh < s, sel(node_freq, nh), _INF)
        nf1 = jnp.where(nh + 1 < s, sel(node_freq, nh + 1), _INF)
        # pick 1st: leaf if leaf <= node (ties to leaf: deterministic,
        # biases toward shallower trees for equal weights)
        take_leaf1 = lf0 <= nf0
        c1 = jnp.where(take_leaf1, lf0, nf0)
        lp1 = lp + take_leaf1.astype(jnp.int32)
        nh1 = nh + (~take_leaf1).astype(jnp.int32)
        # pick 2nd
        lf0b = jnp.where(take_leaf1, lf1, lf0)
        nf0b = jnp.where(take_leaf1, nf0, nf1)
        take_leaf2 = lf0b <= nf0b
        c2 = jnp.where(take_leaf2, lf0b, nf0b)
        lp2 = lp1 + take_leaf2.astype(jnp.int32)
        nh2 = nh1 + (~take_leaf2).astype(jnp.int32)
        newf = jnp.where(created, c1 + c2, _INF)
        node_freq = lax.dynamic_update_slice(
            node_freq, newf[:, None], (0, s)
        )
        lp_out = jnp.where(created, lp2, lp)
        nh_out = jnp.where(created, nh2, nh)
        # children-of-node-s records (for depth recovery):
        #   which queue each child came from + its index there
        y = (
            created,
            take_leaf1, jnp.where(take_leaf1, lp, nh),
            take_leaf2, jnp.where(take_leaf2, lp1, nh1),
        )
        return (lp_out, nh_out, node_freq, err), y

    init = (
        jnp.zeros(N, jnp.int32),
        jnp.zeros(N, jnp.int32),
        jnp.full((N, NN), _INF, jnp.int32),
        jnp.zeros(N, jnp.bool_),
    )
    steps = jnp.arange(NN, dtype=jnp.int32)
    _, ys = lax.scan(step, init, steps)
    created_T, l1_T, i1_T, l2_T, i2_T = ys

    # ---- node depths: reverse scan (parents are created later) ----
    # child node c of node s: depth[c] = depth[s] + 1.  Walk s from the
    # root (last created, depth 0) downward; per-row the root index is
    # n_used - 2.  depth array updated at the CHILD indices... child
    # indices vary per row, so instead compute depth[s] by reading the
    # parent's depth: invert the child records into parent pointers via
    # the node-children consumption order (FIFO: node children are
    # consumed in creation order, so for node c its parent is the step s
    # whose record lists node-child index c).  One forward scan assigns
    # parent pointers positionally; a reverse scan then reads
    # depth[parent] with a one-hot select.
    # parent_of_node[c]: from records — node-children appear in (c)
    # ascending order across steps; rebuild by scanning steps and
    # carrying "next expected node-child index".
    def parent_step(carry, xs):
        par, = carry
        s, created, l1, i1, l2, i2 = xs
        # record parent for node children (l? False => node child)
        upd1 = (~l1) & created
        upd2 = (~l2) & created
        # node child indices are i1/i2; both < s.  Parent write is a
        # "scatter" but to at most 2 per-row slots — do it with one-hot
        # masked where (cheap at [N, 512]).
        oh1 = jnp.where(upd1[:, None], i1[:, None] == iota_nn, False)
        oh2 = jnp.where(upd2[:, None], i2[:, None] == iota_nn, False)
        par = jnp.where(oh1 | oh2, s, par)
        return (par,), None

    (parent,), _ = lax.scan(
        parent_step,
        (jnp.full((N, NN), -1, jnp.int32),),
        (steps, created_T, l1_T, i1_T, l2_T, i2_T),
    )

    # depth by reverse scan: depth[s] = depth[parent[s]] + 1, root = 0
    root = jnp.maximum(n_used - 2, 0)

    def depth_step(carry, s):
        depth, = carry
        par_s = sel(parent, jnp.broadcast_to(s, (N,)))
        pd = sel(depth, par_s)
        is_root = s == root
        d = jnp.where(is_root, 0, pd + 1)
        depth = lax.dynamic_update_slice(depth, d[:, None], (0, s))
        return (depth,), None

    (node_depth,), _ = lax.scan(
        depth_step,
        (jnp.zeros((N, NN), jnp.int32),),
        steps,
        reverse=True,
    )

    # ---- leaf depths: leaf k consumed at the step whose records list
    # leaf index k; leaves are consumed in ascending order (FIFO) ----
    def leafdepth_step(carry, xs):
        ldep, = carry
        s, created, l1, i1, l2, i2 = xs
        dd = sel(node_depth, jnp.broadcast_to(s, (N,))) + 1
        oh1 = jnp.where((l1 & created)[:, None], i1[:, None] == iota_nn, False)
        oh2 = jnp.where((l2 & created)[:, None], i2[:, None] == iota_nn, False)
        ldep = jnp.where(oh1 | oh2, dd[:, None], ldep)
        return (ldep,), None

    (leaf_depth,), _ = lax.scan(
        leafdepth_step,
        (jnp.zeros((N, NN), jnp.int32),),
        (steps, created_T, l1_T, i1_T, l2_T, i2_T),
    )

    leaf_depth = jnp.where(
        n_used[:, None] <= 1,
        jnp.where(iota_nn == 0, 1, 0),
        leaf_depth,
    )

    # ---- 15-bit limit repair on the depth profile (deflate-style) ----
    # counts per depth (clamped), then fix Kraft oversubscription by
    # moving one leaf at a time from the deepest level above a
    # non-full... standard: move a leaf from depth l<15 to l+1 (its
    # sibling subtree gains) — iterate while Kraft > 1.
    depths_c = jnp.minimum(leaf_depth, MAX_CODE_LEN)
    depths_c = jnp.where(iota_nn < n_used[:, None], depths_c, 0)
    lvl = jnp.arange(MAX_CODE_LEN + 1, dtype=jnp.int32)[None, :]  # [1,16]
    cnt = jnp.sum(
        (depths_c[:, :, None] == lvl[:, None, :])
        & (depths_c[:, :, None] > 0),
        axis=1,
    ).astype(jnp.int32)  # [N, 16]

    def kraft(cnt):
        return jnp.sum(cnt * (1 << (MAX_CODE_LEN - lvl[0]))[None, :], axis=1)

    full = 1 << MAX_CODE_LEN

    def repair_cond(cnt):
        return jnp.any(kraft(cnt) > full)

    def repair_step(cnt):
        over = kraft(cnt) > full
        # deepest level l < 15 with cnt[l] > 0: move one leaf l -> l+1
        has = (cnt > 0) & (lvl < MAX_CODE_LEN) & (lvl > 0)
        lsel = jnp.max(jnp.where(has, lvl, 0), axis=1)
        dec = (lvl == lsel[:, None]) & over[:, None]
        inc = (lvl == (lsel + 1)[:, None]) & over[:, None]
        return cnt - dec.astype(jnp.int32) + inc.astype(jnp.int32)

    cnt = lax.while_loop(repair_cond, repair_step, cnt)

    # ---- assign repaired lengths to leaves: longest codes to the
    # smallest-frequency leaves (leaf order is already freq-ascending) ----
    # expansion: leaf k gets the k-th element of the non-increasing
    # sequence [15]*cnt[15] + [14]*cnt[14] + ...
    cum_from_deep = jnp.cumsum(cnt[:, ::-1], axis=1)[:, ::-1]  # cnt[l..15]
    k_iota = iota_nn
    # length(k) = max l such that k < sum_{l'>=l} cnt[l']
    length_k = jnp.zeros((N, NN), jnp.int32)
    for l in range(MAX_CODE_LEN, 0, -1):
        length_k = jnp.where(
            (length_k == 0) & (k_iota < cum_from_deep[:, l : l + 1]),
            l,
            length_k,
        )
    length_k = jnp.where(k_iota < n_used[:, None], length_k, 0)

    # ---- back to symbol order: sort (leaf_sym, length_k) by symbol ----
    _, lengths = sort_rows((leaf_sym, length_k), num_keys=1)
    return lengths


def canonical_from_lengths(lengths):
    """Canonical code values [N, 512] from lengths ([MS-XCA] §2.1.2):
    symbols sorted by (length, symbol); codes increase numerically.

    Also returns (first_code, base_rank, lim) per level [N, 16] for
    arithmetic canonical DEcoding:
      level l matches when  first_code[l] <= peek_l < lim[l];
      rank = base_rank[l] + peek_l - first_code[l]  (rank in (len,sym)
      sort order).
    """
    N, S = lengths.shape
    lvl = jnp.arange(MAX_CODE_LEN + 1, dtype=jnp.int32)[None, :]
    cnt = jnp.sum(
        (lengths[:, :, None] == lvl[:, None, :]) & (lengths[:, :, None] > 0),
        axis=1,
    ).astype(jnp.int32)

    # first_code[l] = (first_code[l-1] + cnt[l-1]) << 1 (15 static steps)
    fc_arr = jnp.zeros((N, MAX_CODE_LEN + 1), jnp.int32)
    br_arr = jnp.zeros((N, MAX_CODE_LEN + 1), jnp.int32)
    code = jnp.zeros(N, jnp.int32)
    rank = jnp.zeros(N, jnp.int32)
    for l in range(1, MAX_CODE_LEN + 1):
        fc_arr = fc_arr.at[:, l].set(code)
        br_arr = br_arr.at[:, l].set(rank)
        code = (code + cnt[:, l]) << 1
        rank = rank + cnt[:, l]
    lim_arr = fc_arr + cnt

    # per-symbol code: rank within level = #symbols with same length and
    # smaller index: via sort by (length, sym)
    sym_iota = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (N, S))
    sort_key = jnp.where(lengths > 0, (lengths << 10) | sym_iota, _INF)
    _, sym_in_rank = sort_rows((sort_key, sym_iota), num_keys=1)
    # rank r holds symbol sym_in_rank[r]; its code = fc[len] + (r - br[len])
    # compute in rank order then sort back to symbol order
    len_in_rank, _ = sort_rows(
        (jnp.where(lengths > 0, lengths, _INF), sym_iota), num_keys=1
    )
    r_iota = sym_iota
    # one-hot select fc/br by level (small: 16)
    lvl16 = jnp.arange(MAX_CODE_LEN + 1, dtype=jnp.int32)[None, None, :]
    oh = len_in_rank[:, :, None] == lvl16
    fc_r = jnp.sum(jnp.where(oh, fc_arr[:, None, :], 0), axis=2)
    br_r = jnp.sum(jnp.where(oh, br_arr[:, None, :], 0), axis=2)
    code_in_rank = jnp.where(
        len_in_rank <= MAX_CODE_LEN, fc_r + (r_iota - br_r), 0
    )
    # back to symbol order
    _, codes = sort_rows((sym_in_rank, code_in_rank), num_keys=1)
    return codes, fc_arr, br_arr, lim_arr


def rank_to_symbol_table(lengths):
    """[N, 512] table: rank (in canonical (len,sym) order) -> symbol.
    Ranks >= #used symbols map to 0."""
    N, S = lengths.shape
    sym_iota = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (N, S))
    sort_key = jnp.where(lengths > 0, (lengths << 10) | sym_iota, _INF)
    _, sym_in_rank = sort_rows((sort_key, sym_iota), num_keys=1)
    used = jnp.sum((lengths > 0).astype(jnp.int32), axis=1)
    return jnp.where(sym_iota < used[:, None], sym_in_rank, 0)
