#!/usr/bin/env python
"""Scaling-efficiency sweep (BASELINE.md config 5) — ALL formats,
encode AND decode (VERDICT r2 missing #2: the r1 harness swept LZNT1
encode only).

Weak scaling: corpus_mb of data PER DEVICE, sharded over meshes of
1..max devices with ('data',) shardings; efficiency(nd) =
GBps(nd) / (GBps(1) * nd).  On the GPUs of one host it measures real
scaling; on a CPU host it exercises a virtual mesh (run with
JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8).

Writes the sweep to chiprun_out/scaling_latest.json and prints it.

Usage:  python benchmarks/scaling.py [corpus_mb_per_device] [pipelines]
        pipelines = comma list from {lznt1,xpress,xh}x{enc,dec}, e.g.
        "lznt1_enc,xh_dec"; default all six.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ART = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "chiprun_out", "scaling_latest.json")

# unit size is a free parameter of the harness; production-default
# 64 KiB units via env (r3's 16 KiB sweep at 0.25 MB/device measured
# fixed costs, not scaling — VERDICT r3 weak #1)
XP_UNIT = int(os.environ.get("TPUCOMP_SCALING_UNIT", "65536"))
XH_UNIT = int(os.environ.get("TPUCOMP_SCALING_UNIT", "65536"))


def _salted(f, args, reps=3):
    """Returns (wall seconds per rep, process-CPU cores used during the
    timed region).  The cores number is the measured ground truth for
    the shared-core ceiling model (annotate_ceiling): XLA:CPU's
    intra-op threads all run inside this process, so
    process_time/wall ~= cores actually consumed; on a real accelerator
    the host sits idle and the number is ~0 (clamped to 1 downstream)."""
    import jax
    import jax.numpy as jnp

    salt = jnp.int32(0)
    r = f(*args, salt)
    jax.block_until_ready(r)
    t0 = time.perf_counter()
    c0 = time.process_time()
    for _ in range(reps):
        r = f(*args, salt)
        salt = jnp.min(jax.tree_util.tree_leaves(r)[0]).astype(jnp.int32) * 0
    jax.block_until_ready((r, salt))
    wall = time.perf_counter() - t0
    cores = (time.process_time() - c0) / max(wall, 1e-9)
    return wall / reps, cores


def _ref_compress(fmt, data):
    """Fast host encoder for decode-sweep stream prep."""
    try:
        from tpucomp import _native

        fn = {"xpress": _native.xpress_compress,
              "xh": _native.xh_compress}[fmt]
        return fn(data)
    except Exception:
        from tpucomp.oracle import xpress as o_xp
        from tpucomp.oracle import xpress_huff as o_xh

        return (o_xp.compress(data) if fmt == "xpress"
                else o_xh.compress(data))


def build_pipelines(corpus_mb):
    """Returns {name: make(nd, sharding) -> (jit_fn, args, bytes_per_dev)}.

    Each make() builds device arrays replicated per device shard (weak
    scaling) and a salted jit with ('data',) in/out shardings.
    """
    import jax
    import jax.numpy as jnp

    from benchmarks.corpus import mixed_corpus
    from tpucomp.codecs import lznt1 as lz
    from tpucomp.codecs import xpress as xp
    from tpucomp.codecs import xpress_huff as xh
    from tpucomp.codecs.lznt1 import decode_batch_impl, encode_batch_impl

    data = mixed_corpus(int(corpus_mb * (1 << 20)))
    nbytes = len(data)

    def rows_for(u):
        n = -(-nbytes // u)
        rows = np.zeros((n, u), np.int32)
        flat = rows.reshape(-1)
        arr = np.frombuffer(data, np.uint8)
        flat[: len(arr)] = arr
        lens = np.minimum(nbytes - np.arange(n) * u, u).astype(np.int32)
        return rows.reshape(n, u), lens

    def tile(a, nd, mult=8):
        """Replicate per-device rows and pad to a mult*nd multiple."""
        n = a.shape[0]
        per = -(-n // mult) * mult
        out = np.zeros((per * nd,) + a.shape[1:], a.dtype)
        for d in range(nd):
            out[d * per : d * per + n] = a
        return out

    def sharded_jit(fn, nargs, sharding):
        """Row-partitioned program (as dist.MeshJit): every device runs
        the pipeline, GPU kernels included, on its own rows."""
        import jax
        from jax.sharding import PartitionSpec as P

        local = jax.shard_map(
            fn, mesh=sharding.mesh, in_specs=(P("data"),) * nargs + (P(),),
            out_specs=P("data"), check_vma=False)
        return jax.jit(local, in_shardings=(sharding,) * nargs + (None,),
                       out_shardings=sharding)

    pipes = {}

    # ---- LZNT1 ----
    chunks, clens = rows_for(lz.CHUNK)

    def mk_lznt1_enc(nd, sharding):
        dc = jax.device_put(tile(chunks, nd), sharding)
        dl = jax.device_put(tile(clens, nd), sharding)
        f = sharded_jit(lambda c, l, s: encode_batch_impl(c, l + s)[1], 2,
                        sharding)
        return f, (dc, dl), nbytes

    pipes["lznt1_enc"] = mk_lznt1_enc

    payload, plen = (np.asarray(x) for x in
                     __import__("jax").jit(encode_batch_impl)(
                         jnp.asarray(chunks), jnp.asarray(clens)))
    dp = np.zeros((chunks.shape[0], lz.PAYLOAD_PAD), np.int32)
    dl_ = np.zeros(chunks.shape[0], np.int32)
    dcmp = np.zeros(chunks.shape[0], bool)
    for k in range(chunks.shape[0]):
        pl, cl = int(plen[k]), int(clens[k])
        if pl < cl:
            dp[k, :pl] = payload[k, :pl]
            dl_[k] = pl
            dcmp[k] = True
        else:
            dp[k, :cl] = chunks[k, :cl]
            dl_[k] = cl

    def mk_lznt1_dec(nd, sharding):
        a = jax.device_put(tile(dp, nd), sharding)
        b = jax.device_put(tile(dl_, nd), sharding)
        c = jax.device_put(tile(dcmp, nd), sharding)
        f = sharded_jit(lambda p, l, m, s: decode_batch_impl(p, l + s, m)[1],
                        3, sharding)
        return f, (a, b, c), nbytes

    pipes["lznt1_dec"] = mk_lznt1_dec

    # ---- Xpress plain ----
    xu_rows, xu_lens = rows_for(XP_UNIT)

    def mk_xp_enc(nd, sharding):
        a = jax.device_put(tile(xu_rows, nd), sharding)
        b = jax.device_put(tile(xu_lens, nd), sharding)
        f = sharded_jit(lambda c, l, s: xp._encode_impl(c, l + s, XP_UNIT)[1],
                        2, sharding)
        return f, (a, b), nbytes

    pipes["xpress_enc"] = mk_xp_enc

    xp_streams = [
        _ref_compress("xpress", data[i : i + XP_UNIT])
        for i in range(0, nbytes, XP_UNIT)
    ]
    PX = min(xp.max_payload(XP_UNIT),
             max(1024, -(-max(len(s) for s in xp_streams) // 4096) * 4096) + 16)
    xpp = np.zeros((len(xp_streams), PX), np.int32)
    xpl = np.zeros(len(xp_streams), np.int32)
    xpo = xu_lens.copy()
    for i, s in enumerate(xp_streams):
        a = np.frombuffer(s, np.uint8)
        xpp[i, : len(a)] = a
        xpl[i] = len(a)

    def mk_xp_dec(nd, sharding):
        a = jax.device_put(tile(xpp, nd), sharding)
        b = jax.device_put(tile(xpl, nd), sharding)
        c = jax.device_put(tile(xpo, nd), sharding)
        f = sharded_jit(
            lambda p, l, o, s: xp._decode_impl(p, l, o + s, XP_UNIT)[0][:, 0],
            3, sharding)
        return f, (a, b, c), nbytes

    pipes["xpress_dec"] = mk_xp_dec

    # ---- Xpress Huffman ----
    xh_rows, xh_lens = rows_for(XH_UNIT)

    def mk_xh_enc(nd, sharding):
        a = jax.device_put(tile(xh_rows, nd), sharding)
        b = jax.device_put(tile(xh_lens, nd), sharding)
        f = sharded_jit(lambda c, l, s: xh._encode_impl(c, l + s, XH_UNIT)[1],
                        2, sharding)
        return f, (a, b), nbytes

    pipes["xh_enc"] = mk_xh_enc

    xh_streams = [
        _ref_compress("xh", data[i : i + XH_UNIT])
        for i in range(0, nbytes, XH_UNIT)
    ]
    ss = max(xh._substeps_for(xh._min_code_len([s])) for s in xh_streams)
    PH = min(xh.max_payload(XH_UNIT),
             max(1024, -(-max(len(s) for s in xh_streams) // 4096) * 4096)
             + 272)
    hp = np.zeros((len(xh_streams), PH), np.int32)
    hl = np.zeros(len(xh_streams), np.int32)
    ho = xh_lens.copy()
    for i, s in enumerate(xh_streams):
        a = np.frombuffer(s, np.uint8)
        hp[i, : len(a)] = a
        hl[i] = len(a)

    def mk_xh_dec(nd, sharding):
        a = jax.device_put(tile(hp, nd), sharding)
        b = jax.device_put(tile(hl, nd), sharding)
        c = jax.device_put(tile(ho, nd), sharding)
        f = sharded_jit(
            lambda p, l, o, s: xh._decode_impl(p, l, o + s, XH_UNIT, ss)[0],
            3, sharding)
        return f, (a, b, c), nbytes

    pipes["xh_dec"] = mk_xh_dec
    return pipes


def main():
    # Shared-core artifact control (VERDICT r3 weak #1): a virtual CPU
    # "device" runs XLA:CPU with host-wide intra-op threading, so ONE
    # device already consumes every physical core and weak scaling can
    # only lose — the r3 sweep's 5% encode "efficiency" measured
    # exactly that.  TPUCOMP_SCALING_1T=1 pins intra-op parallelism to
    # one thread per device so nd <= physical cores measures GSPMD
    # mechanics fairly.  (Set BEFORE the first backend init: XLA reads
    # XLA_FLAGS when the CPU client is created, which is lazy.)
    if os.environ.get("TPUCOMP_SCALING_1T") == "1":
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_cpu_multi_thread_eigen=false"
            + " intra_op_parallelism_threads=1").strip()
    import jax

    from tpucomp.util import use_compile_cache

    use_compile_cache()
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tpucomp.dist import data_mesh

    corpus_mb = float(sys.argv[1]) if len(sys.argv) > 1 else 1.0
    only = sys.argv[2].split(",") if len(sys.argv) > 2 else None
    devs = jax.devices()
    counts = [c for c in [1, 2, 4, 8, 16, 32] if c <= len(devs)]
    pipes = build_pipelines(corpus_mb)
    ncores = os.cpu_count() or 1
    report = {"device": str(devs[0]), "corpus_mb_per_device": corpus_mb,
              "host_physical_cores": ncores, "pipelines": {}}
    if "cpu" in str(devs[0]).lower():
        report["note"] = (
            "virtual CPU mesh: the N 'devices' share this host's physical "
            "cores (and XLA:CPU threads within each), so weak-scaling "
            "efficiency measures sharding mechanics, not hardware scaling")

    for name, make in pipes.items():
        if only and name not in only:
            continue
        rows, base = [], None
        for nd in counts:
            mesh = data_mesh(devs[:nd])
            sharding = NamedSharding(mesh, P("data"))
            f, args, bytes_per_dev = make(nd, sharding)
            dt, cores = _salted(f, args)
            gbps = nd * bytes_per_dev / dt / 1e9
            if base is None:
                base = gbps
            # eff_corebound divides by the host's ACTUAL parallel
            # capacity min(nd, cores): on a shared-core virtual mesh it
            # isolates GSPMD mechanics from the hardware-oversubscription
            # artifact (r3's 5% "efficiency" at 8 devices on 2 cores was
            # the 2/8 ceiling, not a sharding serialization)
            rows.append({
                "devices": nd,
                "GBps": round(gbps, 6),
                "efficiency": round(gbps / (base * nd), 4),
                "eff_corebound": round(
                    gbps / (base * min(nd, ncores)), 4),
                "cores_used": round(cores, 2),
            })
            print(f"# {name} nd={nd} {gbps:.4f} GB/s "
                  f"eff={rows[-1]['efficiency']:.3f} "
                  f"corebound={rows[-1]['eff_corebound']:.3f} "
                  f"cores={cores:.2f}",
                  file=sys.stderr, flush=True)
        annotate_ceiling(rows, ncores)
        report["pipelines"][name] = rows
        # incremental write: a timeout mid-sweep keeps finished pipelines
        os.makedirs(os.path.dirname(ART), exist_ok=True)
        with open(ART, "w") as fh:
            json.dump(report, fh, indent=1)
    print(json.dumps(report))


def annotate_ceiling(rows, ncores):
    """Ceiling-relative efficiency for shared-core virtual meshes.

    XLA:CPU multi-threads a single 'device', so the 1-device baseline
    may already saturate the host.  C1 = the MEASURED process-CPU cores
    the 1-device run consumed (_salted's process_time/wall — r4's
    eff(2)-derived estimate reported eff_vs_ceiling 3.05 for lznt1_dec,
    i.e. the estimator itself was wrong).  The host then physically
    caps the mesh at ceiling(nd) = base * min(nd, ncores/C1), and
    eff_vs_ceiling = GBps/ceiling isolates GSPMD/dispatch overhead from
    hardware oversubscription.  On a real accelerator the host process
    is ~idle (cores ~0 -> C1 clamps to 1) and ceiling(nd) = base*nd —
    the column then equals 'efficiency'."""
    if not rows:
        return
    base = rows[0]["GBps"] or 1e-12
    c1 = rows[0].get("cores_used") or 1.0
    c1 = min(float(ncores), max(1.0, c1))
    for r in rows:
        ceil = base * min(r["devices"], ncores / c1)
        r["eff_vs_ceiling"] = round(r["GBps"] / ceil, 4) if ceil else 0.0
    rows[0]["baseline_cores_meas"] = round(c1, 2)


if __name__ == "__main__":
    main()
