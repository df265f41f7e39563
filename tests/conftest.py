"""Test configuration.

The suite runs on the CPU backend with 8 virtual devices, set BEFORE jax
initializes, so mesh/sharding tests run anywhere (SURVEY.md §4 item 3)
and results are deterministic.  An explicit JAX_PLATFORMS wins: tests
marked ``gpu`` run only where JAX finds a GPU (``JAX_PLATFORMS=cuda
python -m pytest -m gpu``); chip_smoke.py makes the same checks there.
"""

import os

# small unit-batch padding: keeps the CPU-simulated device codecs cheap
os.environ.setdefault("TPUCOMP_BATCH_MULTIPLE", "8")

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import random

import pytest


@pytest.fixture
def rng():
    return random.Random(0xC0FFEE)


def make_corpus(rng, n):
    """Mixed-entropy test buffer: text-ish, runs, periodic, random."""
    out = bytearray()
    words = [b"the ", b"quick ", b"brown ", b"fox ", b"jumps ", b"over ", b"lazy "]
    while len(out) < n:
        kind = rng.randrange(4)
        if kind == 0:
            out += rng.choice(words)
        elif kind == 1:
            out += bytes([rng.randrange(256)]) * rng.randrange(1, 50)
        elif kind == 2:
            pat = bytes(rng.randrange(256) for _ in range(rng.randrange(2, 9)))
            out += pat * rng.randrange(1, 20)
        else:
            out += bytes(rng.randrange(256) for _ in range(rng.randrange(1, 30)))
    return bytes(out[:n])


@pytest.fixture
def corpus(rng):
    return lambda n: make_corpus(rng, n)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided here, never at import)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py covers it there")
