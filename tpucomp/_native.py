"""ctypes binding for the native C codecs (the "cpu" backend).

The shared library is built on demand with the system compiler and
cached next to the source; no pip/pybind11 involved (environment
constraint).  Role parity: the reference's codecs are native C++; this
is tpucomp's native host path — also a second, independent
implementation cross-validated against the oracle in tests.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sysconfig

from .errors import ArgError, BufError, DataError
from .formats import Format, register

_DIR = os.path.join(os.path.dirname(__file__), "native")
_SRC = os.path.join(_DIR, "tpucomp_native.c")
_SO = os.path.join(_DIR, "libtpucomp_native.so")

_lib = None


def _build():
    cc = os.environ.get("CC", "cc")
    cmd = [cc, "-O3", "-fPIC", "-shared", "-o", _SO, _SRC]
    subprocess.run(cmd, check=True, capture_output=True)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
        _build()
    lib = ctypes.CDLL(_SO)
    for name in (
        "lznt1_compress",
        "lznt1_decompress",
        "xpress_compress",
        "xh_compress",
    ):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int,
            ctypes.c_char_p,
            ctypes.c_int,
        ]
    for name in ("xpress_compress_opt", "xh_compress_opt"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int,
            ctypes.c_char_p,
            ctypes.c_int,
            ctypes.c_int,
        ]
    for name in ("xpress_decompress", "xh_decompress"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int,
            ctypes.c_char_p,
            ctypes.c_int,
        ]
    # streaming objects (reference ms_deflate/ms_inflate parity)
    for pre in ("xp_scomp", "xh_scomp", "xp_sdec", "xh_sdec"):
        new = getattr(lib, pre + "_new")
        new.restype = ctypes.c_void_p
        new.argtypes = [ctypes.c_long] if pre.endswith("sdec") else []
        getattr(lib, pre + "_free").restype = None
        getattr(lib, pre + "_free").argtypes = [ctypes.c_void_p]
        feed = getattr(lib, pre + "_feed")
        feed.restype = ctypes.c_int
        feed.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
        fin = getattr(lib, pre + "_finish")
        fin.restype = ctypes.c_int
        fin.argtypes = [ctypes.c_void_p]
        av = getattr(lib, pre + "_avail")
        av.restype = ctypes.c_int
        av.argtypes = [ctypes.c_void_p]
        rd = getattr(lib, pre + "_read")
        rd.restype = ctypes.c_int
        rd.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    _lib = lib
    return lib


def _check(rc: int) -> int:
    if rc == -3:
        raise BufError("native: output buffer too small")
    if rc < 0:
        raise DataError("native: malformed stream")
    return rc


def _call(fn, data: bytes, out_cap: int) -> bytes:
    out = ctypes.create_string_buffer(out_cap)
    rc = _check(fn(data, len(data), out, out_cap))
    return out.raw[:rc]


def _bound(n):
    return n + 2 * (n // 4096 + 2) + 16


def lznt1_compress(data: bytes) -> bytes:
    return _call(_load().lznt1_compress, bytes(data), _bound(len(data)))


def lznt1_decompress(data: bytes, out_len=None) -> bytes:
    data = bytes(data)
    cap = out_len if out_len is not None else max(4096, 4096 * (len(data) // 2 + 2))
    r = _call(_load().lznt1_decompress, data, cap)
    if out_len is not None:
        if len(r) < out_len:
            raise DataError("LZNT1: stream ended before out_len bytes")
        r = r[:out_len]
    return r


def xpress_compress(data: bytes) -> bytes:
    n = len(data)
    return _call(_load().xpress_compress, bytes(data), n + 4 * (n // 32 + 2) + 16)


def xpress_decompress(data: bytes, out_len: int) -> bytes:
    if out_len is None:
        raise ArgError("Xpress: out_len is required")
    return _call(_load().xpress_decompress, bytes(data), out_len)


def xh_compress(data: bytes) -> bytes:
    n = len(data)
    nb = max(1, (n + 65535) // 65536)
    return _call(_load().xh_compress, bytes(data), nb * 264 + 2 * n + 16)


# Encoder option flags (mirror tpucomp_native.c OPT_*)
OPT_RESOLVE_OFFSETS = 1


def _depth_flags(max_depth: int) -> int:
    if not 0 <= max_depth <= 15:
        raise ArgError("max_depth must be in [0, 15]")
    return (max_depth & 0xF) << 8


def _call_opt(fn, data: bytes, out_cap: int, flags: int) -> bytes:
    out = ctypes.create_string_buffer(out_cap)
    rc = _check(fn(data, len(data), out, out_cap, flags))
    return out.raw[:rc]


def _default_depth() -> int:
    # The device decoder's archive probe budget: archives written at this
    # depth resolve entirely in the cheap value-chase probe rounds.
    from .kernels.common import ARCHIVE_PROBE_BUDGET

    return ARCHIVE_PROBE_BUDGET


def xh_compress_resolved(data: bytes, max_depth: int | None = None) -> bytes:
    """xh_compress with the archive-decode profile: encode-time
    origin-ascent offset rewrite plus a HARD bound on the data-parallel
    decoder's copy-resolution depth (``max_depth`` gather rounds after
    the in-scan near window; matches that would exceed it are shortened
    or dropped).  Output is standard [MS-XCA] §2.1/2.2 — any decoder
    accepts it.  ``max_depth=0`` disables the bound (ascent only).

    Default = kernels.common.ARCHIVE_PROBE_BUDGET, the device decoder's
    archive fast-path budget (value-chase probe rounds in
    kernels/common._far_rounds fast=True), so default-depth archives
    resolve entirely in the cheap probes.  Deeper bounds stay correct —
    chains past the probe budget fall through to the decoder's dense
    mop-up level — but the fast path no longer covers them.  Measured
    on the 8 MB bench slice depth 2 keeps +5.3% over unresolved vs
    +8.2% at depth 1."""
    if max_depth is None:
        max_depth = _default_depth()
    n = len(data)
    nb = max(1, (n + 65535) // 65536)
    return _call_opt(_load().xh_compress_opt, bytes(data),
                     nb * 264 + 2 * n + 16,
                     OPT_RESOLVE_OFFSETS | _depth_flags(max_depth))


def xpress_compress_resolved(data: bytes, max_depth: int | None = None) -> bytes:
    """xpress_compress with the archive-decode profile (ascent capped
    by the format's 8192-byte window).  See xh_compress_resolved."""
    if max_depth is None:
        max_depth = _default_depth()
    n = len(data)
    return _call_opt(_load().xpress_compress_opt, bytes(data),
                     n + 4 * (n // 32 + 2) + 16,
                     OPT_RESOLVE_OFFSETS | _depth_flags(max_depth))


def xh_decompress(data: bytes, out_len: int) -> bytes:
    if out_len is None:
        raise ArgError("XpressHuff: out_len is required")
    return _call(_load().xh_decompress, bytes(data), out_len)


class _NativeStream:
    """Common driver for the C stream objects (feed/avail/read/finish)."""

    def __init__(self, prefix: str, *new_args):
        lib = _load()
        self._lib = lib
        self._new = getattr(lib, prefix + "_new")
        self._feed = getattr(lib, prefix + "_feed")
        self._finish = getattr(lib, prefix + "_finish")
        self._avail = getattr(lib, prefix + "_avail")
        self._read = getattr(lib, prefix + "_read")
        self._free = getattr(lib, prefix + "_free")
        self._h = self._new(*new_args)
        if not self._h:
            raise ArgError("native stream: allocation failed")

    def _drain(self) -> bytes:
        # loop: the C *_avail returns int, so a single pass would cap a
        # >INT_MAX pending backlog (huge out_len feeds) at one truncated
        # read; keep reading until the engine reports empty
        parts = []
        while True:
            n = _check(self._avail(self._h))
            if not n:
                break
            buf = ctypes.create_string_buffer(n)
            got = _check(self._read(self._h, buf, n))
            if not got:
                break
            parts.append(buf.raw[:got])
        return b"".join(parts)

    def feed(self, data: bytes) -> bytes:
        data = bytes(data)
        _check(self._feed(self._h, data, len(data)))
        return self._drain()

    def finish(self) -> bytes:
        _check(self._finish(self._h))
        return self._drain()

    def close(self):
        if self._h:
            self._free(self._h)
            self._h = None

    def __del__(self):  # noqa: D105
        try:
            self.close()
        except Exception:
            pass


class NativeStreamCompressor(_NativeStream):
    """Window-carry native streaming encoder (XPRESS / XPRESS_HUFF).

    compress(b) -> finalized stream bytes so far; flush() -> the rest.
    XPRESS_HUFF: streamed bytes == one-shot native xh_compress(concat)
    for any feed slicing.  XPRESS: == one-shot xpress_compress(concat)
    unless a single match would span > 1 MiB of not-yet-fed input (it is
    then emitted early; the stream stays spec-valid).
    """

    def __init__(self, fmt):
        from .formats import canonical

        prefix = {Format.XPRESS: "xp_scomp", Format.XPRESS_HUFF: "xh_scomp"}[
            canonical(fmt)
        ]
        super().__init__(prefix)

    compress = _NativeStream.feed
    flush = _NativeStream.finish


class NativeStreamDecompressor(_NativeStream):
    """Window-carry native streaming decoder (XPRESS / XPRESS_HUFF).

    Feed arbitrary slices of one standard stream; decoded bytes are
    emitted as soon as their tokens/blocks complete.  ``out_len`` is the
    total uncompressed size (the formats carry no size header).
    """

    def __init__(self, fmt, out_len: int):
        if out_len is None or out_len < 0:
            raise ArgError("out_len is required")
        from .formats import canonical

        prefix = {Format.XPRESS: "xp_sdec", Format.XPRESS_HUFF: "xh_sdec"}[
            canonical(fmt)
        ]
        super().__init__(prefix, out_len)

    decompress = _NativeStream.feed
    flush = _NativeStream.finish


def register_all():
    _load()  # build/verify up front; raises if no compiler
    register(Format.LZNT1, "cpu", lznt1_compress, lznt1_decompress)
    register(Format.XPRESS, "cpu", xpress_compress, xpress_decompress)
    register(Format.XPRESS_HUFF, "cpu", xh_compress, xh_decompress)
