"""Lane-scan kernel (interpret mode) against its lax.scan reference at
every call site, the platform chooser, the compile-cache helper, and
chip_smoke.py's refusal to run without a GPU.

The GPU kernel itself is compiled only on the card: the ``gpu`` test
below skips elsewhere, and chip_smoke.py runs the same comparison at
full width there.
"""

import os
import random
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from conftest import make_corpus
from tpucomp import _native
from tpucomp.codecs import lznt1, xpress
from tpucomp.codecs import xpress_huff as xh
from tpucomp.kernels import lane_scan as ls
from tpucomp.kernels.common import greedy_commit

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape and np.array_equal(x, y)


def _rows(streams, width):
    a = np.zeros((len(streams), width), np.int32)
    n = np.zeros(len(streams), np.int32)
    for i, s in enumerate(streams):
        b = np.frombuffer(s, np.uint8)
        a[i, : len(b)] = b
        n[i] = len(b)
    return a, n


def _both(fn, *args, **kw):
    """(scan result, interpret-mode kernel result)."""
    return (fn(*args, impl="scan", **kw), fn(*args, impl="interpret", **kw))


# ---------------------------------------------------------------- chooser


@pytest.mark.parametrize("backend,impl", [
    ("gpu", "kernel"), ("cpu", "scan"), ("tpu", "scan"), ("rocm", "scan")])
def test_choose_impl_by_backend(backend, impl):
    assert ls.choose_impl(backend) == impl


def test_resolve_impl_explicit_and_default():
    assert ls.resolve_impl("interpret") == "interpret"
    assert ls.resolve_impl() == ls.choose_impl(jax.default_backend())
    with pytest.raises(ValueError):
        ls.resolve_impl("tpu")


def test_shl_matches_xla_out_of_range_rule():
    x = jnp.full((6,), 0x1235, jnp.int32)
    s = jnp.asarray([-16, -1, 0, 5, 31, 32], jnp.int32)
    want = np.asarray(jnp.left_shift(x, s))  # XLA: 0 outside [0, 32)
    assert np.array_equal(np.asarray(ls.shl(x, s)), want)


@pytest.mark.parametrize("lanes", [1, 7, 9, 33])
def test_generic_body_lane_padding(lanes):
    """Carry, per-step outputs, 2-D consts, tables and the step index
    agree at lane counts on both sides of the lane block."""
    rng = np.random.default_rng(lanes)
    T = 37
    xs = (jnp.asarray(rng.integers(0, 256, (T, lanes)), jnp.int32),)
    tbl = jnp.asarray(rng.integers(0, 1000, (lanes, 64)), jnp.int32)
    c2 = jnp.asarray(rng.integers(0, 50, (lanes, 16)), jnp.int32)

    def step(carry, x, t, consts, take):
        a, b = carry
        (c,) = consts
        i16 = jnp.arange(16, dtype=jnp.int32)[None, :]
        first = jnp.min(jnp.where(c > (a % 50)[:, None], i16, 99), axis=1)
        a = a + x[0] + take(0, a * 7 + t)  # indices clip to the table
        b = b ^ ls.shl(x[0], (a & 63) - 16) + first * t
        return (a, b), (a, b, first)

    init = (jnp.zeros(lanes, jnp.int32), jnp.ones(lanes, jnp.int32))
    _same(*_both(ls.lane_scan, step, init, xs, (c2,), (tbl,)))


# ---------------------------------------------------------------- LZNT1


def _lznt1_case(case):
    rng = random.Random(7)
    data = make_corpus(rng, 4096 * 5)
    chunks = [data[i:i + 4096] for i in range(0, len(data), 4096)]
    streams = [_native.lznt1_compress(c) for c in chunks]
    payloads, comps = [], []
    for s in streams:
        p, c = lznt1.split_stream(s)
        payloads += p
        comps += c
    if case == "stored_raw":
        comps = [False] * len(comps)
    elif case == "empty":
        payloads = [b""] * 3
        comps = [True, False, True]
    elif case == "garbage":
        payloads = [bytes(rng.randrange(256) for _ in range(900))
                    for _ in range(4)]
        comps = [True] * 4
    elif case == "truncated":
        payloads = [p[: len(p) // 2 + 1] for p in payloads]
    elif case == "max_match":
        payloads, comps = lznt1.split_stream(
            _native.lznt1_compress(b"\0" * 4096 + b"ab" * 2048))
    elif case == "ragged":
        tails = [data[:n] for n in (1, 3, 17, 1000, 4095)]
        payloads, comps = [], []
        for t in tails:
            p, c = lznt1.split_stream(_native.lznt1_compress(t))
            payloads += p
            comps += c
    elif case == "lanes_33":
        payloads = (payloads * 7)[:33]
        comps = (comps * 7)[:33]
    pay, plen = _rows(payloads, lznt1.PAYLOAD_PAD)
    return jnp.asarray(pay), jnp.asarray(plen), jnp.asarray(
        np.array(comps, bool))


@pytest.mark.parametrize("case", [
    "native", "stored_raw", "empty", "garbage", "truncated", "max_match",
    "ragged", "lanes_33"])
def test_lznt1_parse_kernel_matches_scan(case):
    args = _lznt1_case(case)
    ref, got = _both(lznt1.parse_records, *args)
    _same(ref, got)
    if case == "garbage":
        assert np.asarray(ref[3]).any()  # the malformed path was taken


# ---------------------------------------------------------------- Xpress


def _xpress_case(case, U=8192):
    rng = random.Random(11)
    units = [make_corpus(rng, U) for _ in range(3)]
    if case == "long_run":
        U = 65536
        units = [b"\0" * U, b"x" * 300 + b"\0" * 70000]
        units = [u[:U] for u in units]
    elif case == "ragged":
        units = [make_corpus(rng, n) for n in (1, 5, 333, U)]
    streams = [_native.xpress_compress(u) for u in units]
    lens = [len(u) for u in units]
    if case == "empty":
        streams, lens = [b"", b""], [0, 5]
    elif case == "truncated":
        streams = [s[: len(s) // 3] for s in streams]
    elif case == "garbage":
        streams = [bytes(rng.randrange(256) for _ in range(700))
                   for _ in range(3)]
    elif case == "lanes_33":
        streams, lens = (streams * 11)[:33], (lens * 11)[:33]
    pay, plen = _rows(streams, xpress.max_payload(U))
    return (jnp.asarray(pay), jnp.asarray(plen),
            jnp.asarray(np.array(lens, np.int32)), U)


@pytest.mark.parametrize("case", [
    "native", "empty", "truncated", "garbage", "long_run", "ragged",
    "lanes_33"])
def test_xpress_parse_kernel_matches_scan(case):
    pay, plen, olen, U = _xpress_case(case)
    ref, got = _both(xpress.parse_records, pay, plen, olen, U)
    _same(ref, got)
    if case == "truncated":
        p_final = np.asarray(ref[2])
        assert (p_final < np.asarray(olen)).any()


# ---------------------------------------------------------------- XH


def _xh_batch(case, U=8192):
    rng = random.Random(13)
    units = [make_corpus(rng, U),
             bytes(rng.randrange(256) for _ in range(U)),      # mcl >= 8
             bytes(rng.choice(b"aab") for _ in range(U)),       # mcl 1-2
             b"\0" * U]                                         # one run
    if case == "ragged":
        units = [make_corpus(rng, n) for n in (1, 40, 999, U)]
    streams = [_native.xh_compress(u) for u in units]
    lens = [len(u) for u in units]
    if case == "empty":
        streams, lens = [b"\0" * 256, b""], [0, 0]
    elif case == "truncated":
        streams = [s[: 256 + (len(s) - 256) // 2] for s in streams]
    return streams, lens


def _xh_parse(streams, lens, substeps, U=8192, hist_len=None):
    pay, plen = _rows(streams, xh.max_payload(U))
    pay = jnp.asarray(pay)

    def run(impl):
        return xh.parse_records(
            pay[:, 256:], jnp.asarray(plen) - 256,
            jnp.asarray(np.array(lens, np.int32)), xh._unpack_table(pay),
            U, substeps, hist_len=hist_len, impl=impl)

    return run("scan"), run("interpret")


@pytest.mark.parametrize("substeps", [3, 5, 9, 17])
def test_xh_parse_kernel_matches_scan_every_tier(substeps):
    """Every substeps tier, on a batch whose blocks need different tiers
    (a tier too small for a block flags it: both must agree on that)."""
    ref, got = _xh_parse(*_xh_batch("tiers"), substeps)
    _same(ref, got)


@pytest.mark.parametrize("case", ["empty", "truncated", "ragged",
                                  "history"])
def test_xh_parse_kernel_matches_scan(case):
    streams, lens = _xh_batch("tiers" if case == "history" else case)
    hist = None
    if case == "history":  # cross-block window widens the offset check
        hist = jnp.asarray(np.array([0, 100, 65536, 7], np.int32))
    ss = xh._substeps_for(xh._min_code_len(
        [s for s in streams if len(s) >= 256] or [b"\0" * 256]))
    ref, got = _xh_parse(streams, lens, ss, hist_len=hist)
    _same(ref, got)


# ---------------------------------------------------------------- commit


@pytest.mark.parametrize("case", ["random", "all_long", "no_match",
                                  "lanes_33"])
def test_greedy_commit_kernel_matches_scan(case):
    rng = np.random.default_rng(3)
    N, n = (33 if case == "lanes_33" else 4), 4096
    is_match = rng.random((N, n)) < 0.3
    best_len = rng.integers(3, 300, (N, n))
    if case == "all_long":
        is_match[:] = True
        best_len[:] = 4096  # jumps past the row end
    elif case == "no_match":
        is_match[:] = False
    okpos = np.arange(n)[None, :] < rng.integers(0, n + 1, (N, 1))
    args = (jnp.asarray(is_match), jnp.asarray(best_len, jnp.int32),
            jnp.asarray(okpos))
    ref, got = _both(greedy_commit, *args)
    _same(ref, got)
    # oracle: the cursor walk in numpy
    want = np.zeros((N, n), bool)
    for r in range(N):
        p = 0
        while p < n and okpos[r, p]:
            want[r, p] = True
            p += int(best_len[r, p]) if is_match[r, p] else 1
    assert np.array_equal(np.asarray(ref), want)


@pytest.mark.parametrize("n,want", [(4096, "scan"), (8192, None)])
def test_greedy_commit_short_walks_take_the_scan(n, want, monkeypatch):
    """Walks up to COMMIT_SCAN_MAX_STEPS positions run the lax.scan on
    every platform; longer ones leave the choice to the platform."""
    import tpucomp.kernels.common as C

    seen = []
    real = C.lane_scan

    def spy(*a, impl=None, **kw):
        seen.append(impl)
        return real(*a, impl=impl, **kw)

    monkeypatch.setattr(C, "lane_scan", spy)
    z = jnp.zeros((2, n), bool)
    got = C.greedy_commit(z, jnp.ones((2, n), jnp.int32), ~z)
    assert seen == [want]
    assert np.asarray(got).all()  # all literals: every position commits


@pytest.mark.gpu
def test_kernel_matches_scan_on_gpu(gpu):
    args = _lznt1_case("native")
    _same(lznt1.parse_records(*args, impl="kernel"),
          lznt1.parse_records(*args, impl="scan"))


# ---------------------------------------------------------------- tools


def test_compile_cache_dir_from_env(monkeypatch, tmp_path):
    from tpucomp.util import use_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert use_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # nothing set


def test_compile_cache_dir_default(monkeypatch):
    from tpucomp.util import CHECKOUT, use_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = use_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert CHECKOUT == REPO
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("setup", ["no_nvidia_smi", "cpu_platform",
                                   "script_alone"])
def test_chip_smoke_refuses_without_gpu(setup, tmp_path):
    """No GPU, or no repository beside the script: non-zero exit and no
    "ok" line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    cwd = REPO
    if setup != "no_nvidia_smi":
        fake = tmp_path / "bin"
        fake.mkdir()
        smi = fake / "nvidia-smi"
        smi.write_text("#!/bin/sh\necho 'NVIDIA H100 80GB HBM3, 700.00 W'\n")
        smi.chmod(0o755)
        env["PATH"] = f"{fake}{os.pathsep}{env.get('PATH', '')}"
    else:
        env["PATH"] = os.pathsep.join(
            d for d in env.get("PATH", "").split(os.pathsep)
            if not os.path.exists(os.path.join(d, "nvidia-smi")))
    script = os.path.join(REPO, "chip_smoke.py")
    if setup == "script_alone":
        alone = tmp_path / "alone"
        alone.mkdir()
        script = shutil.copy(script, alone / "chip_smoke.py")
        cwd = alone
    r = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
