#!/usr/bin/env python3
"""Smoke run of tpucomp's device codecs on NVIDIA GPUs.

    python chip_smoke.py                # one GPU: kernels + all formats
    python chip_smoke.py --devices 4    # four GPUs: the sharded path only

Drives the main path through the public entry points at real sizes —
LZNT1 32 MiB (8192 chunks of 4 KiB), Xpress 16 MiB (256 units of
64 KiB), Xpress-Huffman 32 MiB (512 blocks of 64 KiB) — on a corpus
generated from ``--seed`` alone, and checks every output bit-exactly.
Each phase prints one JSON line.  On success the last line is
``{"ok": true, "device": {...}}``; any failed check raises, so the
process exits non-zero without that line.  It fails without a GPU.

Times are smoke timings (wall clock; the per-format phases time host
bytes to host bytes, first call including compilation), printed beside
the card's name and power limit.  They are not a benchmark.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

SIZES = {"lznt1": 32 << 20, "xpress": 16 << 20, "xpress_huff": 32 << 20}
UNIT = {"lznt1": 4096, "xpress": 65536, "xpress_huff": 65536}
REPS = 5  # timed calls per measurement
ORACLE_UNITS = 3  # leading units also decoded by the spec oracle

CARD = {}  # card name and power limit, stamped on every timing


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}, default=str), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def wall(fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, time.perf_counter() - t0


def spread(ts):
    return {"median_s": statistics.median(ts), "min_s": min(ts),
            "max_s": max(ts), "n": len(ts)}


# ---------------------------------------------------------------- phases


def phase_environment(ndev):
    # the card's name and power limit, read before JAX touches the card
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    cards = [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]
    check(cards, "nvidia-smi lists no GPU")
    import jax

    from tpucomp.util import use_compile_cache

    cache = use_compile_cache()
    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"JAX platform is {devs[0].platform!r}, not 'gpu'")
    check(len(devs) >= ndev, f"need {ndev} GPUs, JAX sees {len(devs)}")
    CARD.update(card=cards[0])
    for line in cards:
        print(line, flush=True)
    emit("environment", cards=cards, jax=jax.__version__,
         python=sys.version.split()[0], platform=devs[0].platform,
         device_kind=devs[0].device_kind, device_count=len(devs),
         xla_flags=os.environ.get("XLA_FLAGS", ""), compile_cache=cache)
    return devs


def phase_native():
    from tpucomp import _native

    _, secs = wall(_native._load)  # builds from the tracked C source
    emit("native", library=_native._SO, load_s=secs)


def phase_implementations():
    """Which implementation each stage takes; the kept GPU kernels must
    be the ones taken."""
    from tpucomp.kernels.common import COMMIT_SCAN_MAX_STEPS
    from tpucomp.kernels.lane_scan import resolve_impl

    lane = resolve_impl()
    stages = {
        "decode parse (lznt1, xpress, xpress_huff)": f"lane_scan:{lane}",
        "encode greedy commit, 64 KiB units (xpress, xpress_huff)":
            f"lane_scan:{lane}",
        f"encode greedy commit, walks <= {COMMIT_SCAN_MAX_STEPS} "
        "(lznt1)": "lane_scan:scan",
        "decode record fill": "plain XLA",
        "decode copy resolution (near window + far rounds)": "plain XLA",
        "encode match finder, layout, Huffman build": "plain XLA",
    }
    emit("implementations", stages=stages)
    check(lane == "kernel", f"lane_scan took {lane!r} on the GPU")


def _measure(name, kernel_fn, plain_fn, args):
    """Time ``kernel_fn`` (the GPU kernel path, often the very program
    the format phases run later) and ``plain_fn`` (the lax.scan path) on
    the same device ``args``; their outputs must be identical.
    ``first_call_s`` includes compilation."""
    import jax
    import numpy as np

    res, outs = {}, {}
    for impl, fn in (("kernel", kernel_fn), ("scan", plain_fn)):
        t0 = time.perf_counter()
        outs[impl] = jax.block_until_ready(fn(*args))
        first = time.perf_counter() - t0
        ts = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*args))
            ts.append(time.perf_counter() - t0)
        res[impl] = {"first_call_s": first, **spread(ts)}
    ref = jax.tree_util.tree_leaves(outs["scan"])
    got = jax.tree_util.tree_leaves(outs["kernel"])
    check(len(ref) == len(got) and all(
        np.array_equal(np.asarray(a), np.asarray(b))
        for a, b in zip(ref, got)),
        f"{name}: kernel output differs from the lax.scan reference")
    emit("kernels", what=name, identical=True, **CARD, kernel=res["kernel"],
         plain=res["scan"],
         plain_over_kernel=res["scan"]["median_s"] / res["kernel"]["median_s"])


def _rows(streams, width):
    import numpy as np

    a = np.zeros((len(streams), width), np.int32)
    lens = np.zeros(len(streams), np.int32)
    for i, s in enumerate(streams):
        b = np.frombuffer(s, np.uint8)
        a[i, : len(b)] = b
        lens[i] = len(b)
    return a, lens


def phase_kernels(corpus):
    """Each lane_scan call site: the kernel against the lax.scan
    reference at full width, alone and inside its whole device call.
    The whole-call kernel paths are the production programs at the
    shapes the format phases use, so those reuse their compilations."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tpucomp import _native
    from tpucomp.codecs import lznt1, xpress, xpress_huff as xh
    from tpucomp.dist import ShardedCodec
    from tpucomp.kernels.common import greedy_commit

    def both(fn, **kw):
        return (jax.jit(functools.partial(fn, impl="kernel", **kw)),
                jax.jit(functools.partial(fn, impl="scan", **kw)))

    # LZNT1 decode: 8192 chunks
    payloads, comps = lznt1.split_stream(
        _native.lznt1_compress(corpus["lznt1"]))
    pay, plen = _rows(payloads, lznt1.PAYLOAD_PAD)
    args = (jnp.asarray(pay), jnp.asarray(plen),
            jnp.asarray(np.array(comps, bool)))
    _measure("lznt1 parse", *both(lznt1.parse_records), args)
    _measure("lznt1 decode call",
             ShardedCodec("lznt1")._lznt1_jit(False),
             both(lznt1.decode_batch_impl)[1], args)

    # Xpress decode: 256 units of 64 KiB, widths as decompress_units pads
    data = corpus["xpress"]
    U = UNIT["xpress"]
    units = [data[i:i + U] for i in range(0, len(data), U)]
    streams = [_native.xpress_compress(u) for u in units]
    width = min(xpress.max_payload(U),
                max(1024, -(-max(map(len, streams)) // 8192) * 8192) + 16)
    pay, plen = _rows(streams, width)
    olen = jnp.asarray(np.array([len(u) for u in units], np.int32))
    args = (jnp.asarray(pay), jnp.asarray(plen), olen)
    _measure("xpress parse", *both(xpress.parse_records, U=U), args)
    _measure("xpress decode call", xpress._dec_for(U),
             both(xpress._decode_impl, U=U)[1], args)

    # Xpress-Huffman decode: 512 blocks of 64 KiB
    data = corpus["xpress_huff"]
    units = [data[i:i + U] for i in range(0, len(data), U)]
    streams = [_native.xh_compress(u) for u in units]
    ss = xh._substeps_for(xh._min_code_len(streams))
    body = max(1024, -(-(max(map(len, streams)) - 256) // 8192) * 8192)
    pay, plen = _rows(streams, min(xh.max_payload(U), 256 + body + 16))
    olen = jnp.asarray(np.array([len(u) for u in units], np.int32))
    args = (jnp.asarray(pay), jnp.asarray(plen), olen)

    def xh_parse(p, pl, ol, impl):
        return xh.parse_records(p[:, 256:], pl - 256, ol,
                                xh._unpack_table(p), U, ss, impl=impl)

    _measure(f"xpress_huff parse (substeps {ss})", *both(xh_parse), args)
    _measure("xpress_huff decode call", xh._dec_for(U, ss),
             both(xh._decode_impl, U=U, SUBSTEPS=ss)[1], args)

    # greedy commit over 64 KiB walks: the kernel alone, then inside the
    # Xpress-Huffman encode call at the widest encode dispatch
    rng = np.random.default_rng(0)
    rows = len(units)
    is_match = jnp.asarray(rng.random((rows, U)) < 0.3)
    best_len = jnp.asarray(rng.integers(3, 300, (rows, U)), jnp.int32)
    okpos = jnp.arange(U)[None, :] < jnp.asarray(
        rng.integers(0, U + 1, (rows, 1)))
    _measure("greedy commit (64 KiB walks)", *both(greedy_commit),
             (is_match, best_len, okpos))
    blocks, blen = _rows(units, U)
    _measure("xpress_huff encode call", xh._enc_for(U),
             both(xh._encode_impl, U=U)[1],
             (jnp.asarray(blocks), jnp.asarray(blen)))


def _codecs(fmt):
    from tpucomp import _native
    from tpucomp.oracle import lznt1 as o_lznt1
    from tpucomp.oracle import xpress as o_xpress
    from tpucomp.oracle import xpress_huff as o_xh

    return {
        "lznt1": (_native.lznt1_compress, _native.lznt1_decompress,
                  o_lznt1.decompress, None),
        "xpress": (_native.xpress_compress, _native.xpress_decompress,
                   o_xpress.decompress, _native.xpress_compress_resolved),
        "xpress_huff": (_native.xh_compress, _native.xh_decompress,
                        o_xh.decompress, _native.xh_compress_resolved),
    }[fmt]


def phase_format(fmt, data, mesh1):
    """Encode -> decode through compress_batch / decompress_batch and
    ShardedCodec on a one-device mesh, cross-checked against native C
    and the spec oracle, plus device decode of foreign streams."""
    import tpucomp
    from tpucomp.dist import ShardedCodec

    u = UNIT[fmt]
    units = [data[i:i + u] for i in range(0, len(data), u)]
    lens = [len(x) for x in units]
    nat_enc, nat_dec, oracle_dec, nat_resolved = _codecs(fmt)
    t = {}

    streams, t["compress_batch_first_s"] = wall(
        tpucomp.compress_batch, fmt, units, unit_size=u)
    again, t["compress_batch_second_s"] = wall(
        tpucomp.compress_batch, fmt, units, unit_size=u)
    check(again == streams, f"{fmt}: device encode is not deterministic")
    back, t["decompress_batch_first_s"] = wall(
        tpucomp.decompress_batch, fmt, streams, lens, unit_size=u)
    check(b"".join(back) == data, f"{fmt}: device round trip differs")
    back, t["decompress_batch_second_s"] = wall(
        tpucomp.decompress_batch, fmt, streams, lens, unit_size=u)
    check(b"".join(back) == data, f"{fmt}: device round trip differs")

    # device streams decode with native C; the first few with the oracle
    for s, n, x in zip(streams, lens, units):
        check(nat_dec(s, n) == x, f"{fmt}: native C rejects a device stream")
    for s, n, x in list(zip(streams, lens, units))[:ORACLE_UNITS]:
        check(oracle_dec(s, n) == x, f"{fmt}: oracle rejects a device stream")

    # foreign streams from the native encoder decode on the device
    native = [nat_enc(x) for x in units]
    back, t["decompress_batch_native_streams_s"] = wall(
        tpucomp.decompress_batch, fmt, native, lens, unit_size=u)
    check(back == units, f"{fmt}: device decode of native streams differs")
    ratio = sum(map(len, streams)) / len(data)
    ratio_native = sum(map(len, native)) / len(data)

    # ShardedCodec on a one-device mesh: same streams as compress_batch
    sc = ShardedCodec(fmt, mesh=mesh1, unit_size=u)
    arch, t["sharded_compress_s"] = wall(sc.compress, data)
    check(arch.unit_streams() == streams,
          f"{fmt}: ShardedCodec streams differ from compress_batch")
    out, t["sharded_decompress_s"] = wall(sc.decompress, arch)
    check(out == data, f"{fmt}: ShardedCodec round trip differs")

    if nat_resolved is not None:
        # the archive profile: native offset-resolved streams, decoded
        # on the device through the fast resolve
        sca = ShardedCodec(fmt, mesh=mesh1, unit_size=u,
                           resolve_offsets=True)
        arch, _ = wall(sca.compress, data)
        out, t["sharded_decompress_archive_profile_s"] = wall(
            sca.decompress, arch)
        check(out == data, f"{fmt}: archive-profile decode differs")
    else:
        # one foreign multi-chunk stream through the one-shot API
        whole = nat_enc(data)
        out, t["decompress_one_shot_native_stream_s"] = wall(
            tpucomp.decompress, fmt, whole, backend="tpu")
        check(out == data, f"{fmt}: one-shot device decode differs")

    emit("format", format=fmt, bytes=len(data), units=len(units),
         unit_size=u, round_trip="bit-exact", native_c_decodes=len(units),
         oracle_decodes=ORACLE_UNITS, ratio_device=ratio,
         ratio_native_c=ratio_native,
         device_over_native=ratio / ratio_native,
         timing="smoke, not benchmark", **CARD, **t)


def _assert_partitioned(jitter, n, what):
    sh = jitter.last_out_sharding
    check(sh is not None, f"{what}: no sharded program ran")
    check(len(sh.device_set) == n,
          f"{what}: output on {len(sh.device_set)} devices, want {n}")
    check(not sh.is_fully_replicated, f"{what}: output is replicated")


def phase_sharded(fmt, data, devs, n):
    """ShardedCodec over an n-GPU ('data',) mesh against one GPU."""
    from tpucomp.dist import ShardedCodec, data_mesh

    scn = ShardedCodec(fmt, mesh=data_mesh(devs[:n]), unit_size=UNIT[fmt])
    arch, t_enc = wall(scn.compress, data)
    _assert_partitioned(scn.jitter, n, f"{fmt} encode")
    out, t_dec = wall(scn.decompress, arch)
    _assert_partitioned(scn.jitter, n, f"{fmt} decode")
    check(out == data, f"{fmt}: {n}-GPU round trip differs")
    sc1 = ShardedCodec(fmt, mesh=data_mesh(devs[:1]), unit_size=UNIT[fmt])
    arch1, t_enc1 = wall(sc1.compress, data)
    check(arch.unit_streams() == arch1.unit_streams(),
          f"{fmt}: {n}-GPU streams differ from the 1-GPU streams")
    emit("sharded", format=fmt, devices=n, bytes=len(data),
         units=len(arch.unit_streams()), round_trip="bit-exact",
         streams_equal_one_gpu=True, partitioned=True,
         timing="smoke, not benchmark", **CARD,
         compress_s=t_enc, decompress_s=t_dec, compress_one_gpu_s=t_enc1)


# ---------------------------------------------------------------- main


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1)
    ap.add_argument("--phase", action="append",
                    choices=("kernels", "formats"),
                    help="one-GPU phases to run (default: all)")
    args = ap.parse_args(argv)

    devs = phase_environment(args.devices)
    phase_native()
    from benchmarks.corpus import mixed_corpus

    big = mixed_corpus(max(SIZES.values()), args.seed)
    corpus = {fmt: big[:n] for fmt, n in SIZES.items()}
    if args.devices > 1:
        # the formats compile in parallel (compilation dominates here)
        with ThreadPoolExecutor(len(corpus)) as ex:
            runs = [ex.submit(phase_sharded, fmt, data, devs, args.devices)
                    for fmt, data in corpus.items()]
            for r in runs:
                r.result()
    else:
        from tpucomp.dist import data_mesh

        phase_implementations()
        phases = args.phase or ("kernels", "formats")
        if "kernels" in phases:
            phase_kernels(corpus)
        if "formats" in phases:
            for fmt, data in corpus.items():
                phase_format(fmt, data, data_mesh(devs[:1]))
    import jax

    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}), flush=True)


if __name__ == "__main__":
    main()
