"""CPU oracle codecs — spec-exact [MS-XCA] transcriptions.

These are the correctness ground truth for the device codecs (SURVEY.md §0
protocol item 2: the reference mount at /root/reference was empty, so a
small, obviously-correct in-repo CPU codec substitutes for the reference
binary as the bit-compatibility oracle).

Modules:
    lznt1        — [MS-XCA] §2.5 LZNT1
    xpress       — [MS-XCA] §2.3–2.4 plain LZ77
    xpress_huff  — [MS-XCA] §2.1–2.2 LZ77+Huffman
    huffman      — shared length-limited canonical Huffman (package-merge)
"""

from . import lznt1, xpress, xpress_huff  # noqa: F401
