"""Runtime configuration (SURVEY.md §5 "Config / flag system").

The reference used compile-time preprocessor toggles
(``MSCOMP_WITHOUT_<FMT>``-style, ``ALL_AT_ONCE`` — recalled surface);
here configuration is a runtime dataclass: format parameters where the
spec allows them, mesh shape, match-finder effort, backend selection.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass
class MatchFinderConfig:
    """Effort knobs for the shared device match finder (kernels/common.py).

    Read at TRACE time by the encoder impls (hash_candidates /
    multi_matchlens / run_matchlens call sites): mutate
    ``tpucomp.config.DEFAULT.match`` before the first encode of a given
    unit size — jitted encoders cache per unit size and will not
    retrace on later config changes.
    """

    hash_bits: int = 13
    num_candidates: int = 3  # same-hash candidates tried per position
    cap: int = 32  # capped compare depth (bytes) for hash candidates
    run_disps: Tuple[int, ...] = (1, 2, 3)  # exact small-displacement runs
    # second finder pass with a 5-byte hash seed (0 = off): unions a
    # longer-match-biased candidate set at the same sort shape per pass
    # (hq ratio profiles)
    second_hash_cands: int = 0

    def fingerprint(self):
        """Hashable trace-relevant identity, used in jitted-encoder cache
        keys so a config change after first use gets a fresh trace
        instead of a stale cached program."""
        return (self.hash_bits, self.num_candidates, self.cap,
                tuple(self.run_disps), self.second_hash_cands)


@dataclass
class ResolveConfig:
    """LZ copy-resolution knobs (kernels/common.resolve_copies*).

    window: in-scan exact window (larger = fewer far rounds; cost is
    ~window ops per scan step).  ~79% of the bench corpus's copy bytes
    have d <= 512; the value is not re-tuned for the GPU."""

    window: int = 512


@dataclass
class Config:
    backend: str = "auto"  # oracle | cpu | tpu | auto
    batch_multiple: int = int(os.environ.get("TPUCOMP_BATCH_MULTIPLE", "256"))
    xpress_unit_size: int = 65536  # batch-mode segment size (plain Xpress)
    xh_unit_size: int = 65536  # <= 65536 (single block per unit)
    # Widest single ENCODE dispatch for 64 KiB-unit formats: wider
    # batches are processed in encode_batch_cap-row slices (one compile,
    # reused), which bounds device memory.  On the H100 a 512-row XH
    # encode took 250 ms and 3.7 GB of temporaries against 4 x 80 ms at
    # 128 rows (PERF.md, PR 1).
    encode_batch_cap: int = int(os.environ.get("TPUCOMP_ENCODE_CAP", "512"))
    match: MatchFinderConfig = field(default_factory=MatchFinderConfig)
    resolve: ResolveConfig = field(default_factory=ResolveConfig)
    emit_lznt1_terminator: bool = False
    mesh_axis: str = "data"


DEFAULT = Config()
