"""Lane-scan: a per-lane sequential loop run as ONE GPU kernel.

The byte-lockstep parses (LZNT1, Xpress, Xpress-Huffman decode) and the
greedy-commit cursor walks of the encoders are loops of up to ~64 K
steps whose step body is elementwise over a ``[lanes]`` vector (one lane
per unit).  XLA runs ``lax.scan`` on the GPU as a loop of kernel
launches, one iteration per step, so the loop cost is launch overhead,
not work.  :func:`lane_scan` runs the same step body either as that
``lax.scan`` (the plain reference, and the path on every non-GPU
backend) or inside a single Pallas ``pallas_call(backend="triton")``:

* each program owns ``BLOCK_LANES`` consecutive lanes (one warp);
* ``lax.fori_loop`` walks the steps with the carry in registers;
* per-step operands are read step-major (``xs[t, lanes]``) and per-step
  outputs written step-major (``ys[t, y, lanes]``), so a warp's loads
  and stores are coalesced;
* per-lane table lookups (``take``) are gather loads from the lane's
  own table row instead of one-hot selects.

The step body is shared by both implementations, so the kernel and its
reference cannot drift.  Its contract:

    step(carry, x, t, consts, take) -> (carry, ys)

``carry``: tuple of ``[L]`` int32 vectors; ``x``: tuple of ``[L]`` int32
step operands; ``t``: the int32 step index (a scalar); ``consts``: tuple
of per-lane ``[L]`` or ``[L, k]`` arrays (``k`` a power of two);
``take(i, idx)``: ``tables[i][lane, clip(idx)]`` for an ``[L]`` index
vector; ``ys``: tuple of ``[L]`` int32 per-step outputs.  The body must
build any array constant it needs (e.g. an iota) itself: a GPU kernel
cannot capture arrays.  Shift amounts must stay in ``[0, 31]`` wherever
the result is used (:func:`shl` gives XLA's semantics outside it).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

# 8 lanes per one-warp program: the XH parse (512 blocks) ran in 108 ms
# against 191 ms at 32 lanes, since more programs spread over more SMs;
# the commit walk did not change (PERF.md, PR 1).
BLOCK_LANES = 8
NUM_WARPS = 1

IMPLS = ("kernel", "scan", "interpret")


def choose_impl(backend: str) -> str:
    """The one place the implementation is chosen: the Triton kernel on
    the GPU, the ``lax.scan`` reference on any other backend."""
    return "kernel" if backend == "gpu" else "scan"


def resolve_impl(impl=None) -> str:
    """``impl`` if given (tests and measurements), else by platform."""
    if impl is None:
        return choose_impl(jax.default_backend())
    if impl not in IMPLS:
        raise ValueError(f"lane_scan impl must be one of {IMPLS}, got {impl!r}")
    return impl


def shl(x, s):
    """``x << s`` with XLA's out-of-range rule (0 unless 0 <= s < 32),
    well defined in both implementations."""
    ok = (s >= 0) & (s < 32)
    return jnp.where(ok, jnp.left_shift(x, jnp.clip(s, 0, 31)), 0)


def lane_scan(step, init, xs, consts=(), tables=(), *, impl=None, unroll=1):
    """Run ``step`` over ``t = 0 .. T-1`` for every lane.

    Args:
      step:   the step body (module docstring).
      init:   tuple of ``[N]`` int32 initial carries.
      xs:     tuple of ``[T, N]`` int32 step-major operands.
      consts: tuple of per-lane ``[N]`` / ``[N, k]`` int32 arrays.
      tables: tuple of ``[N, K]`` int32 arrays read through ``take``.
      impl:   None (by platform), "kernel", "scan" or "interpret" (the
              kernel under the Pallas interpreter; CPU tests).
      unroll: steps per loop iteration.  The scan unrolls its body; the
              kernel issues the iteration's ``unroll`` step loads at
              once, so their latency overlaps instead of adding up.

    Returns ``(carry, ys)``: the final carry tuple and the per-step
    outputs stacked as one int32 ``[T, Y, N]`` array.
    """
    impl = resolve_impl(impl)
    init = tuple(jnp.asarray(c, jnp.int32) for c in init)
    xs = tuple(jnp.asarray(x, jnp.int32) for x in xs)
    consts = tuple(jnp.asarray(c, jnp.int32) for c in consts)
    tables = tuple(jnp.asarray(t, jnp.int32) for t in tables)
    T = xs[0].shape[0]
    if impl == "scan":
        return _scan(step, init, xs, consts, tables, T, unroll)
    return _kernel(step, init, xs, consts, tables, T, impl == "interpret",
                   unroll)


def _scan(step, init, xs, consts, tables, T, unroll):
    def take(i, idx):
        tbl = tables[i]
        k = jnp.clip(idx, 0, tbl.shape[1] - 1)
        return jnp.take_along_axis(tbl, k[:, None], axis=1)[:, 0]

    def body(carry, xt):
        t, x = xt[0], xt[1:]
        carry, ys = step(carry, x, t, consts, take)
        return tuple(carry), jnp.stack(
            [y.astype(jnp.int32) for y in ys])

    steps = jnp.arange(T, dtype=jnp.int32)
    return lax.scan(body, init, (steps, *xs), unroll=unroll)


def _n_outputs(step, init, xs, consts, tables):
    """Number of per-step outputs, from an abstract trace of one step."""
    def one(init, x, consts):
        def take(i, idx):
            return jnp.zeros_like(idx)

        return step(init, x, jnp.int32(0), consts, take)

    x0 = tuple(x[0] for x in xs)
    _, ys = jax.eval_shape(one, init, x0, consts)
    return len(ys)


def _kernel(step, init, xs, consts, tables, T, interpret, K):
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plt

    B = BLOCK_LANES
    N = init[0].shape[0]
    npad = -(-N // B) * B
    Y = _n_outputs(step, init, xs, consts, tables)

    def padl(a, axis):
        if npad == N:
            return a
        pad = [(0, 0)] * a.ndim
        pad[axis] = (0, npad - N)
        return jnp.pad(a, pad)

    init_p = tuple(padl(c, 0) for c in init)
    xs_p = tuple(padl(x, 1) for x in xs)
    consts_p = tuple(padl(c, 0) for c in consts)
    tables_p = tuple(padl(t, 0) for t in tables)
    nc, nx, nk = len(init), len(xs), len(consts)
    sizes = tuple(t.shape[1] for t in tables)

    def kernel(*refs):
        init_r = refs[:nc]
        x_r = refs[nc:nc + nx]
        k_r = refs[nc + nx:nc + nx + nk]
        t_r = refs[nc + nx + nk:len(refs) - 1 - nc]
        ys_r = refs[len(refs) - 1 - nc]
        out_r = refs[len(refs) - nc:]
        lane0 = pl.program_id(0) * B
        lanes = pl.ds(lane0, B)
        lane_idx = lane0 + jnp.arange(B, dtype=jnp.int32)
        cs = tuple(r[lanes] if len(r.shape) == 1 else r[lanes, :]
                   for r in k_r)

        def take(i, idx):
            return t_r[i][lane_idx, jnp.clip(idx, 0, sizes[i] - 1)]

        def steps(t0, k, carry):
            xk = [tuple(r[t0 + j, lanes] for r in x_r) for j in range(k)]
            for j in range(k):
                carry, ys = step(carry, xk[j], t0 + j, cs, take)
                for y, v in enumerate(ys):
                    ys_r[t0 + j, y, lanes] = v.astype(jnp.int32)
            return tuple(carry)

        carry = tuple(r[lanes] for r in init_r)
        carry = lax.fori_loop(0, T // K,
                              lambda i, c: steps(i * K, K, c), carry)
        carry = lax.fori_loop(T // K * K, T,
                              lambda t, c: steps(t, 1, c), carry)
        for r, v in zip(out_r, carry):
            r[lanes] = v

    out_shape = (jax.ShapeDtypeStruct((T, Y, npad), jnp.int32),) + tuple(
        jax.ShapeDtypeStruct((npad,), jnp.int32) for _ in range(nc))
    outs = pl.pallas_call(
        kernel,
        out_shape=out_shape,
        grid=(npad // B,),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=1),
        interpret=interpret,
        name="lane_scan",
    )(*init_p, *xs_p, *consts_p, *tables_p)
    ys, carry = outs[0], outs[1:]
    return tuple(c[:N] for c in carry), ys[:, :, :N]
