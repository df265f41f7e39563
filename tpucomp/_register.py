"""Populate the codec registry with the available backends.

Import order matters only in that this module must run after
:mod:`tpucomp.formats`; it is imported from ``tpucomp/__init__.py``.
The device backends (the ``"tpu"`` key) come from :mod:`tpucomp.codecs`;
TPUCOMP_NO_JAX=1 skips them so pure-CPU users (and native-encode worker
processes) never import JAX.
"""

from __future__ import annotations

from .formats import Format, register
from .oracle import lznt1 as _o_lznt1
from .oracle import xpress as _o_xpress
from .oracle import xpress_huff as _o_xh




register(
    Format.LZNT1,
    "oracle",
    _o_lznt1.compress,
    _o_lznt1.decompress,
    max_compressed_size=_o_lznt1.max_compressed_size,
)
register(
    Format.XPRESS,
    "oracle",
    _o_xpress.compress,
    _o_xpress.decompress,
    max_compressed_size=_o_xpress.max_compressed_size,
)
register(
    Format.XPRESS_HUFF,
    "oracle",
    _o_xh.compress,
    _o_xh.decompress,
    max_compressed_size=_o_xh.max_compressed_size,
)

# Native C fast path (ctypes extension), if built.
try:
    from . import _native

    _native.register_all()
except Exception:  # extension not built — oracle remains the CPU path
    pass

# Device (JAX) batched pipelines.  Guard: JAX import is heavy and some
# consumers only want the CPU paths.
import os as _os

if not _os.environ.get("TPUCOMP_NO_JAX"):
    from .codecs import lznt1 as _t_lznt1
    from .codecs import xpress as _t_xpress
    from .codecs import xpress_huff as _t_xh

    register(
        Format.LZNT1,
        "tpu",
        _t_lznt1.compress,
        _t_lznt1.decompress,
    )
    register(
        Format.XPRESS,
        "tpu",
        _t_xpress.compress,
        _t_xpress.decompress,
    )
    register(
        Format.XPRESS_HUFF,
        "tpu",
        _t_xh.compress,
        _t_xh.decompress,
    )
