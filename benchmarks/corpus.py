"""Deterministic benchmark corpus, generated from a seed alone.

No file of the machine is read, so every machine and every commit sees
identical bytes for the same ``(total, seed)``.  The corpus is a
sequence of 0.5-4 KiB segments of five kinds, drawn in fixed proportions:
natural-language-like text, program-source-like text, structured
records (CSV lines and packed binary structs), run-heavy data (zero
pages and byte runs) and incompressible random bytes.  Segments are
short next to a 64 KiB unit, so every unit holds a similar blend.
"""

from __future__ import annotations

import random
import struct

# (kind, weight): proportions of segments
_KINDS = (("text", 30), ("source", 25), ("records", 20), ("runs", 10),
          ("random", 15))


def _vocabulary(rng: random.Random, n: int, lo: int, hi: int):
    letters = "etaoinshrdlcumwfgypbvkjxqz"
    weights = [26 - i for i in range(26)]
    return ["".join(rng.choices(letters, weights, k=rng.randint(lo, hi)))
            for _ in range(n)]


class _Gen:
    def __init__(self, seed: int):
        self.rng = random.Random(seed)
        rng = self.rng
        self.words = _vocabulary(rng, 2000, 2, 10)
        # Zipf-like word frequencies
        acc, cum = 0.0, []
        for r in range(len(self.words)):
            acc += 1.0 / (r + 1)
            cum.append(acc)
        self.word_cum = cum
        self.idents = _vocabulary(rng, 300, 3, 12)
        self.keywords = ["def", "return", "if", "else", "for", "while",
                         "import", "class", "with", "yield", "assert"]
        self.record_id = 0
        self.stamp = 1_600_000_000

    def text(self, n: int) -> bytes:
        rng = self.rng
        words = rng.choices(self.words, cum_weights=self.word_cum,
                            k=n // 5 + 8)
        out, col = [], 0
        for i, w in enumerate(words):
            out.append(w)
            col += len(w) + 1
            if i % 13 == 12:
                out.append(".")
            if col > 72:
                out.append("\n")
                col = 0
            else:
                out.append(" ")
        return "".join(out).encode()[:n]

    def source(self, n: int) -> bytes:
        rng = self.rng
        lines, size, depth = [], 0, 0
        while size < n:
            kw = rng.choice(self.keywords)
            a, b, c = rng.choices(self.idents, k=3)
            form = rng.randrange(4)
            if form == 0:
                line = f"{kw} {a}({b}, {c}):"
            elif form == 1:
                line = f"{a} = {b}.{c}({rng.randrange(1000)})"
            elif form == 2:
                line = f"{kw} {a}[{b}] + {c}"
            else:
                line = f"# {a} {b} {c}"
            line = "    " * depth + line + "\n"
            depth = max(0, min(4, depth + rng.choice((-1, 0, 0, 1))))
            lines.append(line)
            size += len(line)
        return "".join(lines).encode()[:n]

    def records(self, n: int) -> bytes:
        rng = self.rng
        out, size = [], 0
        binary = rng.random() < 0.5
        status = ("OK", "PENDING", "FAILED", "RETRY")
        while size < n:
            self.record_id += 1
            self.stamp += rng.randrange(1, 60)
            amount = rng.randrange(100_000)
            if binary:
                rec = struct.pack("<IIiHH", self.record_id, self.stamp,
                                  amount, rng.randrange(4), 0)
            else:
                rec = (f"{self.record_id:08d},{self.stamp},"
                       f"{rng.choice(self.idents)},{amount / 100:.2f},"
                       f"{rng.choice(status)}\n").encode()
            out.append(rec)
            size += len(rec)
        return b"".join(out)[:n]

    def runs(self, n: int) -> bytes:
        rng = self.rng
        out, size = [], 0
        while size < n:
            length = rng.choice((rng.randrange(4, 64), rng.randrange(256, 4096)))
            value = 0 if rng.random() < 0.5 else rng.randrange(256)
            out.append(bytes([value]) * length)
            size += length
        return b"".join(out)[:n]

    def random(self, n: int) -> bytes:
        return self.rng.randbytes(n)


def mixed_corpus(total: int, seed: int = 0) -> bytes:
    """``total`` bytes of the mixed corpus for ``seed``."""
    gen = _Gen(seed)
    kinds = [k for k, _ in _KINDS]
    weights = [w for _, w in _KINDS]
    out, size = [], 0
    while size < total:
        kind = gen.rng.choices(kinds, weights)[0]
        seg = getattr(gen, kind)(gen.rng.randrange(512, 4096))
        out.append(seg)
        size += len(seg)
    return b"".join(out)[:total]
