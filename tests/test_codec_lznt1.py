"""Device LZNT1 codec vs oracle: cross-decode/encode bit-compatibility."""

import numpy as np
import pytest

from tpucomp.codecs import lznt1 as t_lznt1
from tpucomp.oracle import lznt1 as o_lznt1


def cases(corpus, rng):
    return [
        b"",
        b"x",
        b"abc" * 50,
        b"a" * 4096,
        b"a" * 10000,
        bytes(range(256)) * 32,          # periodic, period 256
        corpus(4096),
        corpus(4097),
        corpus(12288),
        corpus(20000),
        bytes(rng.randrange(256) for _ in range(8192)),  # incompressible
        b"\x00" * 8192,
        (b"ab" * 3000),                  # period 2
        corpus(4095),
    ]


class TestDecodeBitCompat:
    """Device decode must accept any oracle (reference-semantics) stream."""

    def test_decode_oracle_streams(self, corpus, rng):
        for data in cases(corpus, rng):
            c = o_lznt1.compress(data)
            assert t_lznt1.decompress(c) == data, len(data)

    def test_decode_with_terminator(self, corpus):
        data = corpus(9000)
        c = o_lznt1.compress(data, emit_terminator=True)
        assert t_lznt1.decompress(c) == data

    def test_decode_late_position_tokens(self):
        # hand-built stream exercising the narrow-length splits (pos>2048)
        data = bytes(range(256)) * 16    # 4096 bytes, period 256
        c = o_lznt1.compress(data)
        assert t_lznt1.decompress(c) == data

    def test_decode_out_len(self, corpus):
        data = corpus(9000)
        c = o_lznt1.compress(data)
        assert t_lznt1.decompress(c, out_len=5000) == data[:5000]


class TestEncodeValidity:
    """Device encode must produce streams the oracle decodes byte-exactly,
    at sizes <= the stored-raw bound and competitive with the oracle."""

    def test_oracle_decodes_tpu_streams(self, corpus, rng):
        for data in cases(corpus, rng):
            c = t_lznt1.compress(data)
            assert o_lznt1.decompress(c) == data, len(data)
            assert len(c) <= t_lznt1.max_compressed_size(len(data))

    def test_self_roundtrip(self, corpus):
        data = corpus(50000)
        c = t_lznt1.compress(data)
        assert t_lznt1.decompress(c) == data

    def test_ratio_close_to_oracle(self, corpus):
        data = corpus(65536)
        c_t = len(t_lznt1.compress(data))
        c_o = len(o_lznt1.compress(data))
        # ratcheted gate: measured 1.0023 on this corpus at default
        # effort after the saturated-match extension; BASELINE bar is
        # <= oracle size
        assert c_t <= c_o * 1.01, (c_t, c_o)

    def test_rle_compresses_hard(self):
        data = b"\x00" * 40960
        c = t_lznt1.compress(data)
        assert len(c) < 200
        assert o_lznt1.decompress(c) == data


class TestErrorPaths:
    def test_corrupt_disp(self):
        payload = bytes([0x01]) + (0x0000).to_bytes(2, "little")
        header = 0xB000 | (len(payload) - 1)
        with pytest.raises(Exception):
            t_lznt1.decompress(header.to_bytes(2, "little") + bytes(payload))

    def test_truncated_payload(self):
        with pytest.raises(Exception):
            t_lznt1.decompress(bytes([0xFF, 0xB0, 0x00]))
