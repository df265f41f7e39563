"""Device codec pipelines (JAX/XLA; Pallas Triton lane-scan kernels).

Each codec exposes:
* device functions operating on fixed-shape batches of independent units
  (``[n_units, unit_size]`` int32 arrays) — jittable, shardable over a mesh;
* host wrappers implementing the ``bytes -> bytes`` one-shot API on top
  (split / pad / stitch), registered as the ``"tpu"`` backend (a name:
  it runs on whatever device JAX uses).

Design notes (SURVEY.md §7): all sequential structure is confined to
lockstep token scans whose per-step work is vectorized across the unit
batch (lanes = units); variable-length copy chains are resolved in
O(log unit_size) row-wise gathers by pointer doubling rather than
byte-at-a-time copies.
"""

from . import lznt1, xpress, xpress_huff  # noqa: F401
