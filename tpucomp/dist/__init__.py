"""Mesh data-parallelism: the framework's new layer.

The reference has NO parallelism components (SURVEY.md §2: single-threaded
C++, no SIMD/GPU/networking).  This layer is designed fresh
(SURVEY.md §2 "first-class new components", §5):

* 1-D device mesh ``('data',)`` — compression units (LZNT1 4 KiB chunks,
  Xpress/XH 64 KiB blocks) are independent by format design, so data
  parallelism over units is the only axis that applies; no cross-unit
  state means no ring/Ulysses analog is needed.
* jit with ``NamedSharding(P('data'))`` over ``[num_units, ...]``
  batches, the batch programs under ``shard_map`` (row-independent, so
  each device runs its own rows; no collectives inside a program).
* Ragged compressed outputs ride fixed-shape padded buffers + true-length
  vectors; the ordered stitch (drop padding, concatenate in unit order)
  happens on host 0.
"""

from .mesh import data_mesh, local_device_count  # noqa: F401
from .batch import ShardedLZNT1  # noqa: F401
from .archive import Archive, Manifest  # noqa: F401
from .sharded import ShardedCodec  # noqa: F401
from .mixed import MixedBatch  # noqa: F401
