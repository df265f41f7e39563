"""Real multi-process mesh test (VERDICT r1 missing #3).

Spawns 2 OS processes that form a jax.distributed CPU ring (4 virtual
devices each -> one 8-device global ('data',) mesh), run the sharded
codec end-to-end, and exercise _host_gather's process_allgather branch —
the multi-host ragged gather
(SURVEY.md §5 "Distributed comm backend").
"""

import os
import socket
import subprocess
import sys

import pytest

_WORKER = r'''
import sys

coord, pid = sys.argv[1], int(sys.argv[2])

import os
os.environ["TPUCOMP_BATCH_MULTIPLE"] = "8"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=4"
).strip()

import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(
    coordinator_address=coord, num_processes=2, process_id=pid)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 8, len(jax.devices())

from tpucomp import Format
from tpucomp.dist import ShardedCodec
from tpucomp.oracle import xpress_huff as oracle

data = (b"multi-process mesh gather " * 4096)[: 8 * 8192]
sc = ShardedCodec(Format.XPRESS_HUFF, unit_size=8192)
arch = sc.compress(data)            # jit over the GLOBAL mesh
assert sc.decompress(arch) == data  # _host_gather -> process_allgather
s0 = arch.unit_streams()[0]
assert oracle.decompress(s0, arch.manifest.unit_out_lens[0]) == data[:8192]
sh = sc.jitter.last_out_sharding
assert sh is not None and len(sh.device_set) == 8, sh
print(f"WORKER_OK {pid}", flush=True)
'''


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_mesh_gather(tmp_path):
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    # children configure their own virtual-device count / platform
    env.pop("JAX_PLATFORMS", None)
    env["XLA_FLAGS"] = ""
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER, coord, str(pid)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            env=env,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=540)
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-3000:]}"
        assert f"WORKER_OK {pid}" in out, out[-3000:]
