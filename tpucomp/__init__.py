"""tpucomp — Microsoft compression codecs (LZNT1, Xpress, Xpress
Huffman) batched on the GPU, built from scratch in JAX/XLA/Pallas.

Capability parity target: coderforlife/ms-compress (reference mount was
empty at survey time — SURVEY.md §0; semantics are grounded in the public
[MS-XCA] specification with an in-repo CPU oracle as ground truth).

Quick start::

    import tpucomp
    c = tpucomp.compress(tpucomp.Format.LZNT1, b"data...")
    d = tpucomp.decompress(tpucomp.Format.LZNT1, c)

Device-batched / mesh-sharded operation lives in :mod:`tpucomp.dist`.
"""

from .errors import (  # noqa: F401
    ArgError,
    BufError,
    DataError,
    MemError,
    MSCompError,
    Status,
    UnsupportedFormatError,
)
from .formats import Format, registered_formats  # noqa: F401
from .api import (  # noqa: F401
    Compressor,
    Decompressor,
    compress,
    compress_batch,
    decompress,
    decompress_batch,
    max_compressed_size,
)

from . import _register  # noqa: F401  (populates the codec registry)

__version__ = "0.1.0"
