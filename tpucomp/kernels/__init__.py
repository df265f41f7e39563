"""Shared device kernel building blocks (SURVEY.md §2 rows 7–9 equivalents).

Data-parallel primitives without scatters or per-row gathers inside
loops: scans, one-shot gathers, rolls, binary search and XLA sorts, plus
the lane-scan kernel (lane_scan.py) for the per-lane sequential walks.
"""

from .common import (  # noqa: F401
    searchsorted_rows,
    le_words,
    hash_candidates,
    capped_matchlen,
    run_matchlens,
)
