"""Mesh-sharded batch codecs + ordered host stitch.

``ShardedLZNT1`` shards the ``[n_chunks, 4096]`` unit batch over the
``('data',)`` mesh; every device encodes/decodes its resident chunks with
the same lockstep kernels as the single-chip path (tpucomp.codecs.lznt1);
outputs come back as (padded payloads, true lengths) and host 0 stitches
them in unit order.  Because LZNT1 chunks are self-framing (2-byte headers
carry the payload size), the stitched result is a standard LZNT1 stream —
interop with any [MS-XCA] §2.5 decoder is preserved.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..codecs import lznt1 as codec
from ..codecs.lznt1 import decode_batch_impl, encode_batch_impl
from ..errors import DataError
from .sharded import MeshJit

CHUNK = codec.CHUNK


class ShardedLZNT1:
    """LZNT1 over a data-parallel device mesh."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.ndev = mesh.devices.size
        jitter = MeshJit(mesh)
        self._encode = jitter(encode_batch_impl)
        self._decode = jitter(decode_batch_impl)

    def _pad(self, n: int) -> int:
        m = max(self.ndev, 8)
        return max(m, -(-n // m) * m)

    # -- encode ------------------------------------------------------------

    def compress(self, data: bytes) -> bytes:
        data = bytes(data)
        if not data:
            return b""
        nchunks = -(-len(data) // CHUNK)
        N = self._pad(nchunks)
        chunks = np.zeros((N, CHUNK), np.int32)
        clen = np.zeros(N, np.int32)
        arr = np.frombuffer(data, np.uint8)
        flat = chunks[:nchunks].reshape(-1)
        flat[: len(arr)] = arr
        chunks[:nchunks] = flat.reshape(nchunks, CHUNK)
        clen[:nchunks] = np.minimum(
            len(arr) - np.arange(nchunks) * CHUNK, CHUNK
        )
        payload, plen = self._encode(chunks, clen)
        payload = np.asarray(jax.device_get(payload))
        plen = np.asarray(jax.device_get(plen))
        # ordered stitch on host 0 (stored-raw fallback per chunk)
        out = bytearray()
        for k in range(nchunks):
            pl = int(plen[k])
            cl = int(clen[k])
            if pl < cl:
                out += (0xB000 | (pl - 1)).to_bytes(2, "little")
                out += payload[k, :pl].astype(np.uint8).tobytes()
            else:
                out += (0x3000 | (cl - 1)).to_bytes(2, "little")
                out += data[k * CHUNK : k * CHUNK + cl]
        return bytes(out)

    # -- decode ------------------------------------------------------------

    def decompress(self, data: bytes, out_len=None) -> bytes:
        data = bytes(data)
        if not data:
            return b""
        payloads, comps = codec.split_stream(data)
        if not payloads:
            return b""
        N = self._pad(len(payloads))
        payload = np.zeros((N, codec.PAYLOAD_PAD), np.int32)
        plen = np.zeros(N, np.int32)
        is_comp = np.zeros(N, bool)
        for k, (pl, cp) in enumerate(zip(payloads, comps)):
            a = np.frombuffer(pl, np.uint8)
            payload[k, : len(a)] = a
            plen[k] = len(a)
            is_comp[k] = cp
        out, out_lens, err = self._decode(payload, plen, is_comp)
        out = np.asarray(jax.device_get(out))
        out_lens = np.asarray(jax.device_get(out_lens))
        if np.asarray(jax.device_get(err))[: len(payloads)].any():
            raise DataError("LZNT1: malformed stream")
        k = len(payloads)
        parts = [
            out[i, : int(out_lens[i])].astype(np.uint8).tobytes()
            for i in range(k)
        ]
        result = b"".join(parts)
        if out_len is not None:
            if len(result) < out_len:
                raise DataError("LZNT1: stream ended before out_len bytes")
            result = result[:out_len]
        return result
