"""Generic mesh-sharded codecs for all formats + multi-host gather.

``ShardedCodec`` shards fixed-size unit batches over the ('data',) mesh
(units are independent by format design — SURVEY.md §2 parallel table),
runs the per-format batch kernels under GSPMD, gathers (payload,
lengths) and stitches on host 0 in unit order into an Archive.

Multi-host: after ``jax.distributed.initialize()`` the same code shards
globally; ``_host_gather`` uses ``multihost_utils.process_allgather`` to
materialize every shard on host 0 (padded payloads + true lengths, the
classic ragged-gather recipe — SURVEY.md §5 "Distributed comm backend").
On a single process it is the identity.
"""

from __future__ import annotations

import threading

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..errors import ArgError
from ..formats import Format, canonical
from ..util import pad_batch
from .archive import Archive, Manifest
from .mesh import data_mesh


def _host_gather(x):
    """Fully materialize a (possibly multi-host sharded) array on host.

    Multi-process: ``process_allgather`` rides XLA collectives — the
    classic ragged gather (SURVEY.md §5).  Exercised by
    tests/test_multiprocess.py on a 2-process CPU ring.
    """
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(jax.device_get(x))


class MeshJit:
    """jit factory that partitions the batch dim over ('data',).

    Passed as ``jitter`` into the codec modules' batch entry points so
    every per-format kernel (not just LZNT1) runs partitioned.  Every
    batch program is row-independent, so it runs under ``shard_map``:
    each device runs the whole program (GPU kernels included) on its
    own rows.  The ``key`` attribute keys the modules' compile caches;
    the last output sharding computed by the calling thread is recorded
    for partition assertions (tests, dryrun_multichip, chip_smoke.py).
    """

    _instances = {}

    def __new__(cls, mesh):
        # One instance per device set: the codec modules' compile caches
        # key on ``jitter.key``, so the wrapper (and its recorded
        # sharding) must be shared by every codec using the same mesh.
        key = ("mesh", tuple(int(d.id) for d in mesh.devices.flat))
        if key not in cls._instances:
            inst = super().__new__(cls)
            inst.mesh = mesh
            inst.sharding = NamedSharding(mesh, P("data"))
            inst.key = key
            inst._last = threading.local()
            cls._instances[key] = inst
        return cls._instances[key]

    def __init__(self, mesh):
        pass  # state lives in __new__'s per-mesh singleton

    @property
    def last_out_sharding(self):
        return getattr(self._last, "sharding", None)

    def __call__(self, fn):
        local = jax.shard_map(fn, mesh=self.mesh, in_specs=P("data"),
                              out_specs=P("data"), check_vma=False)
        jf = jax.jit(local, in_shardings=self.sharding,
                     out_shardings=self.sharding)

        def wrapped(*args):
            out = jf(*args)
            self._last.sharding = jax.tree_util.tree_leaves(out)[0].sharding
            return out

        return wrapped


_LZNT1_JITS = {}


class ShardedCodec:
    """Data-parallel unit codec over a device mesh (any format)."""

    def __init__(self, fmt, mesh=None, unit_size=None, trace_dir=None,
                 resolve_offsets=False):
        self.fmt = canonical(fmt)
        self.mesh = mesh if mesh is not None else data_mesh()
        self.ndev = self.mesh.devices.size
        self.batch_sharding = NamedSharding(self.mesh, P("data"))
        self.jitter = MeshJit(self.mesh)
        self.last_stats = None
        # jax.profiler trace scope around every device dispatch
        # (SURVEY.md §5 tracing row); None disables
        self.trace_dir = trace_dir
        # archive profile: encode XPRESS/XPRESS_HUFF units with the
        # native offset-resolved, depth-bounded encoder
        # (_native.*_compress_resolved) and mark the manifest so
        # decompress takes the value-chase fast resolve.  The streams
        # stay standard [MS-XCA]; decode of either profile is
        # bit-correct on every backend.
        self.resolve_offsets = bool(resolve_offsets)
        if self.resolve_offsets and canonical(fmt) == Format.LZNT1:
            raise ArgError(
                "resolve_offsets applies to XPRESS/XPRESS_HUFF (LZNT1 "
                "chunks resolve in-segment already)")

        if self.fmt == Format.LZNT1:
            from ..codecs import lznt1 as m

            self.unit_size = unit_size or m.CHUNK
            if self.unit_size != m.CHUNK:
                raise ArgError("LZNT1 units are fixed 4096-byte chunks")
            self._mod = m
        elif self.fmt == Format.XPRESS:
            from ..codecs import xpress as m

            self.unit_size = unit_size or m.UNIT
            self._mod = m
        elif self.fmt == Format.XPRESS_HUFF:
            from ..codecs import xpress_huff as m

            self.unit_size = unit_size or m.BLOCK
            if self.unit_size > m.BLOCK:
                raise ArgError("XPRESS_HUFF units are single <=64 KiB blocks")
            self._mod = m
        else:
            raise ArgError(f"no sharded codec for {self.fmt.name}")

    def _pad(self, n):
        m = max(self.ndev, 8)
        b = pad_batch(n)
        return -(-b // m) * m

    # ---- encode ----------------------------------------------------------

    def compress(self, data: bytes, *, resume: "Archive|None" = None) -> Archive:
        from ..stats import RunStats, timed

        data = bytes(data)
        u = self.unit_size
        units = [data[i : i + u] for i in range(0, len(data), u)] or [b""]
        start = resume.manifest.done_units if resume else 0
        manifest = (
            resume.manifest
            if resume
            else Manifest(fmt=int(self.fmt), unit_size=u)
        )
        payload = bytearray(resume.payload if resume else b"")
        todo = units[start:]
        stats = RunStats(fmt=self.fmt.name, units=len(todo))
        if todo:
            from ..stats import device_trace

            with timed(stats), device_trace(self.trace_dir):
                streams = self._compress_units(todo)
            for s, unit in zip(streams, todo):
                manifest.unit_out_lens.append(len(unit))
                manifest.unit_comp_lens.append(len(s))
                payload += s
            manifest.done_units = len(units)
            manifest.resolved = self.resolve_offsets
            stats.in_bytes = sum(len(t) for t in todo)
            stats.out_bytes = sum(len(s) for s in streams)
        self.last_stats = stats
        return Archive(manifest, bytes(payload))

    def _compress_units(self, units):
        if self.fmt == Format.LZNT1:
            return self._lznt1_units(units, encode=True)
        if self.resolve_offsets:
            from .. import _native

            enc = (_native.xh_compress_resolved
                   if self.fmt == Format.XPRESS_HUFF
                   else _native.xpress_compress_resolved)
            return [enc(u) for u in units]
        return self._mod.compress_units(
            units, unit_size=self.unit_size, jitter=self.jitter,
            pad_to=max(self.ndev, 8), gather=_host_gather)

    # ---- decode ----------------------------------------------------------

    def decompress(self, archive: Archive) -> bytes:
        from ..stats import RunStats, timed

        if archive.manifest.fmt != int(self.fmt):
            raise ArgError("archive format mismatch")
        streams = archive.unit_streams()
        out_lens = archive.manifest.unit_out_lens
        stats = RunStats(fmt=self.fmt.name, units=len(streams),
                         out_bytes=len(archive.payload))
        from ..stats import device_trace

        with timed(stats), device_trace(self.trace_dir):
            if self.fmt == Format.LZNT1:
                parts = self._lznt1_units(streams, encode=False)
            else:
                kw = {}
                if getattr(archive.manifest, "resolved", False):
                    kw["fast_resolve"] = True
                parts = self._mod.decompress_units(
                    streams, out_lens, unit_size=self.unit_size,
                    jitter=self.jitter, pad_to=max(self.ndev, 8),
                    gather=_host_gather, **kw)
        out = b"".join(parts)
        stats.in_bytes = len(out)
        self.last_stats = stats
        return out

    # ---- LZNT1 unit adapters (chunk == unit) -----------------------------

    def _lznt1_jit(self, encode: bool):
        # one compiled program per mesh, shared by every instance (the
        # batch API builds a new ShardedCodec per call)
        from ..codecs.lznt1 import decode_batch_impl, encode_batch_impl

        key = (self.jitter.key, encode)
        if key not in _LZNT1_JITS:
            impl = encode_batch_impl if encode else decode_batch_impl
            _LZNT1_JITS[key] = self.jitter(impl)
        return _LZNT1_JITS[key]

    def _lznt1_units(self, units, encode: bool):
        m = self._mod
        if encode:
            N = self._pad(len(units))
            chunks = np.zeros((N, m.CHUNK), np.int32)
            clen = np.zeros(N, np.int32)
            for i, ud in enumerate(units):
                a = np.frombuffer(ud, np.uint8)
                chunks[i, : len(a)] = a
                clen[i] = len(a)
            payload, plen = self._lznt1_jit(True)(
                jnp.asarray(chunks), jnp.asarray(clen))
            payload = _host_gather(payload)
            plen = _host_gather(plen)
            out = []
            for i, ud in enumerate(units):
                pl, cl = int(plen[i]), int(clen[i])
                if pl < cl:
                    out.append(
                        (0xB000 | (pl - 1)).to_bytes(2, "little")
                        + payload[i, :pl].astype(np.uint8).tobytes()
                    )
                else:
                    out.append((0x3000 | (cl - 1)).to_bytes(2, "little") + ud)
            return out
        else:
            # Each unit stream is a standard LZNT1 stream — possibly a
            # FOREIGN multi-chunk one.  [MS-XCA] §2.5 headers are
            # self-framing (payload_len-1 in bits 0-11), so split every
            # unit into its chunks on host, decode ALL chunks in one
            # batch, and reassemble per unit.  A 0x0000 header (or end
            # of data) terminates a unit's stream.
            chunks = []  # (unit_idx, body_offset, body_len, is_comp)
            for i, s in enumerate(units):
                off = 0
                while off + 2 <= len(s):
                    header = s[off] | (s[off + 1] << 8)
                    if header == 0:
                        break
                    size = (header & 0xFFF) + 1
                    if off + 2 + size > len(s):
                        raise ArgError("LZNT1: truncated chunk in unit")
                    chunks.append((i, off + 2, size, bool(header & 0x8000)))
                    off += 2 + size
            N = self._pad(len(chunks))
            payload = np.zeros((N, m.PAYLOAD_PAD), np.int32)
            plen = np.zeros(N, np.int32)
            is_comp = np.zeros(N, bool)
            for k, (i, boff, size, comp) in enumerate(chunks):
                body = np.frombuffer(units[i][boff : boff + size], np.uint8)
                payload[k, :size] = body
                plen[k] = size
                is_comp[k] = comp
            out, out_lens, err = self._lznt1_jit(False)(
                jnp.asarray(payload), jnp.asarray(plen), jnp.asarray(is_comp)
            )
            out = _host_gather(out)
            out_lens = _host_gather(out_lens)
            if _host_gather(err)[: len(chunks)].any():
                raise ArgError("LZNT1: malformed unit")
            parts = [[] for _ in units]
            for k, (i, _, _, _) in enumerate(chunks):
                parts[i].append(
                    out[k, : int(out_lens[k])].astype(np.uint8).tobytes())
            return [b"".join(p) for p in parts]
