"""Archive fast-path coverage: offset-resolved native streams + the
value-chase probe decode (fast_resolve=True).

The native ``*_compress_resolved`` profile (tpucomp/native/
tpucomp_native.c rw_* — origin ascent + decode-depth bound) guarantees
the device decoder's far resolution converges within the archive budget:
the cond-driven 4 KiB doubling level plus TWO probe rounds
(kernels/common._far_rounds fast=True).  These tests pin:

* bit-exact decode of resolved streams through the device pipeline with
  fast_resolve on, at every supported depth bound;
* fast_resolve stays semantics-preserving for FOREIGN (unresolved)
  streams — the probes are a shortcut, not a contract change;
* the depth model invariant itself: after the near walk + segment
  level, every surviving far tag resolves within max_depth probes
  (checked with the decoder's own kernels, not just end-to-end).
"""

import numpy as np
import pytest

from tpucomp import _native
from tpucomp.codecs import xpress as t_xp
from tpucomp.codecs import xpress_huff as t_xh


def _cases(corpus, rng):
    return [
        corpus(65536),
        corpus(30000),
        b"ab" * 32768,  # periodic: deep overlap chains
        bytes(rng.randrange(256) for _ in range(8192)),  # incompressible
        corpus(4096) * 16,  # long-range self-similarity
    ]


class TestResolvedStreamsDecode:
    @pytest.mark.parametrize("depth", [0, 1, 2, 4])
    def test_xh_resolved_bit_exact(self, corpus, rng, depth):
        cases = _cases(corpus, rng)
        streams = [_native.xh_compress_resolved(d, depth) for d in cases]
        out = t_xh.decompress_units(
            streams, [len(d) for d in cases], fast_resolve=True)
        for d, o in zip(cases, out):
            assert o == d, len(d)

    @pytest.mark.parametrize("depth", [1, 2])
    def test_xpress_resolved_bit_exact(self, corpus, rng, depth):
        cases = _cases(corpus, rng)
        streams = [_native.xpress_compress_resolved(d, depth)
                   for d in cases]
        out = t_xp.decompress_units(
            streams, [len(d) for d in cases], fast_resolve=True)
        for d, o in zip(cases, out):
            assert o == d, len(d)

    def test_fast_resolve_foreign_streams_unchanged(self, corpus, rng):
        # probes are a no-op shortcut on streams with NO depth bound:
        # plain native output must decode identically either way
        cases = _cases(corpus, rng)
        streams = [_native.xh_compress(d) for d in cases]
        lens = [len(d) for d in cases]
        slow = t_xh.decompress_units(streams, lens, fast_resolve=False)
        fast = t_xh.decompress_units(streams, lens, fast_resolve=True)
        assert slow == fast == cases


class TestDepthModelInvariant:
    """The encoder's R/CL model must match the decoder's actual
    convergence: after near walk + 4 KiB segment level, every tag
    resolves in <= max_depth value-chase probes (no dense rounds)."""

    @pytest.mark.parametrize("depth", [1, 2])
    def test_probes_clear_all_tags(self, corpus, depth):
        import jax.numpy as jnp

        from tpucomp.kernels.common import (
            FAR_TAG,
            _far_level_segmented,
            _far_probe_round,
        )

        # full blocks only: positions beyond a short block's out_len
        # are don't-cares whose tags legitimately never resolve
        U = 65536
        data = corpus(U) + (corpus(8192) * 8)[:U]
        blocks = [data[i:i + U] for i in range(0, len(data), U)]
        assert all(len(b) == U for b in blocks)
        streams = [_native.xh_compress_resolved(b, depth) for b in blocks]

        # drive the real pipeline up to the far rounds by monkeypatching
        # the far entry to capture its input (the post-near tag state);
        # the callee runs under jit, so the snapshot rides an ordered
        # io_callback (kept live by donating its token into the result
        # via the real far rounds' input)
        from jax.experimental import io_callback

        import tpucomp.kernels.common as kc

        captured = []
        real = kc._far_rounds

        def snap(a, u):
            captured.append((np.asarray(a), int(u)))

        def capture(out, u, min_hop, fast=False, max_hop=None):
            io_callback(snap, None, out, np.int32(u), ordered=True)
            return real(out, u, min_hop, fast=fast, max_hop=max_hop)

        kc._far_rounds = capture
        # cached decoders would bake a PREVIOUS test's captured-list
        # callback (or none at all) into the jitted program — trace
        # fresh, and leave no capture-contaminated entries behind
        t_xh._DECODERS.clear()
        try:
            outs = t_xh.decompress_units(
                streams, [len(b) for b in blocks], fast_resolve=True)
        finally:
            kc._far_rounds = real
            t_xh._DECODERS.clear()
        assert outs == blocks
        assert captured, "far rounds never entered"

        for tagged0, u in captured:
            st = jnp.asarray(tagged0)
            st = _far_level_segmented(st, u, 4096, cap=6)
            for _ in range(depth):
                st = _far_probe_round(st, u)
            left = int(np.asarray((st & FAR_TAG) != 0).sum())
            assert left == 0, (
                f"{left} tags unresolved after {depth} probes")
