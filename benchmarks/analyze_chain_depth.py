"""Offline census of the data-parallel decoder's resolve schedule.

Uses the native debug decoder (per-byte displacement + token start) to
simulate, in numpy, exactly what kernels/resolve_pallas +
kernels/common._far_level_segmented do: periodic fold, segment-local
near walk with pointer ADOPTION, then 4 KiB in-segment pointer
doubling.  Reports chain-depth distributions and leftover tags — the
ground truth for the archive encoder's R/CL depth model
(tpucomp_native.c rw_*).

    python benchmarks/analyze_chain_depth.py [corpus_mb] [nblocks]
"""

import ctypes
import sys

import numpy as np

sys.path.insert(0, ".")

SEG = 512
S4K = 4096
U = 65536


def tokens_of(stream, out_len):
    from tpucomp import _native

    lib = _native._load()
    fn = lib.xh_decompress_dbg
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    out = ctypes.create_string_buffer(out_len)
    disp = np.zeros(out_len, np.int32)
    tokp = np.zeros(out_len, np.int32)
    rc = fn(stream, len(stream), out,
            out_len, disp.ctypes.data, tokp.ctypes.data)
    assert rc == out_len, rc
    return out.raw, disp, tokp


def simulate(disp, tokp):
    """Returns (state_src, final) after near walk; state_src = -1 where
    final, else the (folded, possibly adopted) source position."""
    n = len(disp)
    j = np.arange(n)
    rel = j - tokp
    d = disp.copy()
    iscp = d > 0
    dc = np.maximum(d, 1)
    src = np.where(iscp & (rel >= dc), tokp + rel % dc, j - d)
    final = ~iscp
    ptr = np.where(iscp, src, -1)
    # near walk: per 512-seg sequential adoption
    for s0 in range(0, n, SEG):
        s1 = min(s0 + SEG, n)
        for k in range(s0, s1):
            p = ptr[k]
            if p >= s0 and p < k:  # same-seg earlier: adopt
                final[k] = final[p]
                ptr[k] = ptr[p]
    return ptr, final


def doubling_census(ptr, final, cap=16):
    n = len(ptr)
    j = np.arange(n)
    live = ~final
    rounds_used = np.zeros(n, np.int32)
    for r in range(cap):
        local = live & (ptr >= 0) & ((ptr // S4K) == (j // S4K))
        if not local.any():
            break
        t = ptr[np.where(local, ptr, 0)]
        f = final[np.where(local, ptr, 0)]
        resolved = local & f
        final[resolved] = True
        live[resolved] = False
        adopt = local & ~f
        ptr[adopt] = t[adopt]
        rounds_used[local] = r + 1
    leftover_local = live & (ptr >= 0) & ((ptr // S4K) == (j // S4K))
    return rounds_used, leftover_local, live


def main():
    corpus_mb = int(sys.argv[1]) if len(sys.argv) > 1 else 28
    nb = int(sys.argv[2]) if len(sys.argv) > 2 else 12
    from benchmarks.corpus import mixed_corpus
    from tpucomp import _native

    data = mixed_corpus(corpus_mb << 20)
    blocks = [data[i:i + U] for i in range(0, len(data), U)]
    step = max(1, len(blocks) // nb)
    worst = 0
    for bi in range(0, len(blocks), step):
        blk = blocks[bi]
        if len(blk) < U:
            continue
        s = _native.xh_compress_resolved(blk)
        out, disp, tokp = tokens_of(s, len(blk))
        assert out == blk
        ptr, final = simulate(disp, tokp)
        tags0 = int((~final).sum())
        ru, leftover, live = doubling_census(ptr.copy(), final.copy())
        mx = int(ru.max())
        worst = max(worst, mx)
        print(f"block {bi}: post-near tags {tags0} "
              f"({100 * tags0 / U:.0f}%), 4k rounds used {mx}, "
              f"in-seg leftover after 16 {int(leftover.sum())}, "
              f"cross-tags {int((live & ~leftover).sum())}")
        if mx > 4 or leftover.any():
            # depth histogram of the offenders
            hist = np.bincount(ru[ru > 0], minlength=17)
            print(f"  round histogram: {hist[1:].tolist()}")
            off = np.where(ru >= mx)[0][:5]
            print(f"  deepest positions: {off.tolist()} "
                  f"disp {disp[off].tolist()}")
    print(f"# worst 4k rounds needed anywhere: {worst} "
          f"(model budget: ceil(log2(RW_CHAIN_CAP=8)) = 3)")


if __name__ == "__main__":
    main()
