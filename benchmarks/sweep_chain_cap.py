"""Sweep the native archive-profile chain cap vs compressed size.

The decoder's 4 KiB in-segment pointer-doubling level runs
ceil(log2(max chain)) cond-driven rounds (kernels/common.
_far_level_segmented): the encoder's RW_CHAIN_CAP is the knob that
trades archive size for decode rounds.  This measures the size side on
the bench slice so the knee can be picked with data.

    python benchmarks/sweep_chain_cap.py [corpus_mb]
"""

import ctypes
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, ".")

SRC = "tpucomp/native/tpucomp_native.c"


def build(cap):
    so = os.path.join(tempfile.gettempdir(), f"tpn_cap{cap}.so")
    subprocess.run(
        ["cc", "-O3", "-fPIC", "-shared", f"-DRW_CHAIN_CAP={cap}",
         "-o", so, SRC], check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    for name in ("xh_compress_opt", "xpress_compress_opt", "xh_compress",
                 "xpress_compress", "xh_decompress", "xpress_decompress"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
                       ctypes.c_int] + (
            [ctypes.c_int] if name.endswith("_opt") else [])
    return lib


def main():
    corpus_mb = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    from benchmarks.corpus import mixed_corpus

    data = mixed_corpus(corpus_mb << 20)
    U = 65536
    units = [data[i:i + U] for i in range(0, len(data), U)]

    lib0 = build(48)

    def enc_all(lib, fname, depth):
        tot = 0
        flags = 1 | (depth << 8)
        fn = getattr(lib, fname)
        dec = getattr(lib, fname.replace("compress_opt", "decompress"))
        for u in units:
            cap = 2 * len(u) + 4096
            out = ctypes.create_string_buffer(cap)
            rc = fn(u, len(u), out, cap, flags)
            assert rc > 0, rc
            tot += rc
            back = ctypes.create_string_buffer(len(u))
            rd = dec(out.raw[:rc], rc, back, len(u))
            assert rd == len(u) and back.raw == u, "roundtrip failed"
        return tot

    def plain(lib, fname):
        tot = 0
        fn = getattr(lib, fname)
        for u in units:
            cap = 2 * len(u) + 4096
            out = ctypes.create_string_buffer(cap)
            rc = fn(u, len(u), out, cap)
            assert rc > 0
            tot += rc
        return tot

    base_xh = plain(lib0, "xh_compress")
    base_xp = plain(lib0, "xpress_compress")
    print(f"# corpus {corpus_mb} MB, {len(units)} units")
    print(f"# plain: xh {base_xh}  xp {base_xp}")
    for cap in (48, 24, 12, 6, 3, 1):
        lib = build(cap)
        xh = enc_all(lib, "xh_compress_opt", 1)
        xp = enc_all(lib, "xpress_compress_opt", 1)
        print(f"cap={cap:3d}  xh {xh} (+{100 * (xh / base_xh - 1):.2f}%)"
              f"  xp {xp} (+{100 * (xp / base_xp - 1):.2f}%)")


if __name__ == "__main__":
    main()
