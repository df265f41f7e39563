"""Small host/device helpers shared by the device codecs."""

from __future__ import annotations

import os

import numpy as np

# Unit-batch rows are padded up to mult * 2^k bucket sizes: few distinct
# shapes (bounded jit recompiles).  256 is a multiple of the lane-scan
# kernel's 32-lane blocks; it is not tuned for the GPU.  Tests set
# TPUCOMP_BATCH_MULTIPLE=8 to keep CPU simulation cheap.
BATCH_MULTIPLE = int(os.environ.get("TPUCOMP_BATCH_MULTIPLE", "256"))


def pad_batch(n: int, mult: int | None = None) -> int:
    if mult is None:
        # runtime knob (tpucomp.config wires the env default)
        from .config import DEFAULT

        mult = DEFAULT.batch_multiple
    m = mult
    while m < n:
        m *= 2
    return m


def bytes_to_rows(data: bytes, row_len: int, pad: int = 0) -> np.ndarray:
    """Split bytes into a [n_rows, row_len] int32 array, zero-padded."""
    arr = np.frombuffer(data, dtype=np.uint8)
    n_rows = max(1, -(-len(arr) // row_len)) if len(arr) else 0
    out = np.zeros((n_rows, row_len), dtype=np.int32)
    if pad:
        out = np.zeros((n_rows, row_len + pad), dtype=np.int32)
    if len(arr):
        flat = out[:, :row_len].reshape(-1)
        flat[: len(arr)] = arr
    return out


def pad_rows(rows, row_len: int) -> np.ndarray:
    """Stack variable-length byte strings into [n, row_len] int32 (zero pad)."""
    out = np.zeros((len(rows), row_len), dtype=np.int32)
    for i, r in enumerate(rows):
        a = np.frombuffer(r, dtype=np.uint8)
        out[i, : len(a)] = a
    return out


def rows_to_bytes(arr: np.ndarray, lengths) -> bytes:
    """Concatenate the first lengths[i] bytes of each row."""
    arr = np.asarray(arr)
    parts = [arr[i, : int(l)].astype(np.uint8).tobytes() for i, l in enumerate(lengths)]
    return b"".join(parts)


# the checkout this package lives in (its parent directory)
CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def use_compile_cache() -> str:
    """Keep JAX's persistent compile cache at a fixed path; returns it.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here; otherwise the cache goes to
    ``<checkout>/.jax_cache``.  The path is part of the cache key, so it
    must not move between runs."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
