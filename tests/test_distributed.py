"""Multi-process "fake pod" tier (SURVEY.md §4: a tier the reference lacks).

Two CPU processes × 4 virtual devices, coordinated through
jax.distributed.initialize; MeshCodec runs over the global 8-device mesh
and every process must produce reference-identical bytes.

Hardening:
  * encode_global feeds each host's LOCAL shard only — the worker instruments
    every cross-host gather and asserts no payload is input-sized (the raw
    input is never replicated; only compressed words + O(blocks) metadata
    travel).
  * shard lengths are UNEQUAL across hosts (interior padding masked by
    per-block valid counts).
  * both the 1-D data mesh and the 2-D (process × local) mesh are
    exercised.
  * a timed-out bring-up retries once and then FAILS (no silent skip).
"""

import os
import socket
import subprocess
import sys

import pytest

_WORKER = r"""
import os, sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np

pid = int(sys.argv[1]); nproc = int(sys.argv[2]); coord = sys.argv[3]
meshkind = sys.argv[4]
try:  # cross-process CPU collectives need an explicit implementation
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
except Exception:
    pass
jax.distributed.initialize(coordinator_address=coord, num_processes=nproc,
                           process_id=pid)
sys.path.insert(0, os.getcwd())  # launched with cwd = repo root
import tpu_huffman as th
from tpu_huffman import distributed as dist
from jax.experimental import multihost_utils

assert jax.process_count() == nproc
assert len(jax.devices()) == 8, jax.devices()

# Instrument every cross-host gather: the encode path must never move an
# input-sized payload (shard.py looks the symbol up on the module at call
# time, so patching the module attribute intercepts it).
orig_ag = multihost_utils.process_allgather
gathered = []

def spy(x, tiled=False):
    try:  # works for np arrays and (non-addressable) global jax.Arrays
        gathered.append(int(x.size) * x.dtype.itemsize)
    except Exception:
        gathered.append(np.asarray(x).nbytes)
    return orig_ag(x, tiled=tiled)

multihost_utils.process_allgather = spy

table = th.load_static_test_table()
mesh = dist.process_local_mesh() if meshkind == "dcn_ici" else dist.global_data_mesh()
codec = th.MeshCodec(table, mesh, block_symbols=256)

rng = np.random.default_rng(77)
full = rng.integers(0, 256, size=20_000, dtype=np.uint8).tobytes()
split = 12_032  # UNEQUAL shards: hosts contribute different byte counts
mine = full[:split] if pid == 0 else full[split:]

encoded, index = dist.encode_global(codec, mine)
expected = th.encode(full, table)
assert encoded == expected, "multi-process encode != single-process bytes"
# No input replication: every gathered payload is far below the raw input
# (compressed words ~= output size; totals/offsets are O(devices)+O(blocks)).
assert gathered and max(gathered) <= max(2 * len(encoded), 4096), gathered
n_enc_gathers = len(gathered)

assert dist.decode_global(codec, encoded, index) == full
print(f"proc {pid} OK {meshkind} gathers={n_enc_gathers}", flush=True)
"""


def _run_pod(tmp_path, meshkind: str):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"

    worker = tmp_path / f"worker_{meshkind}.py"
    worker.write_text(_WORKER)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env.pop("JAX_PLATFORMS", None)
    here = os.path.dirname(os.path.abspath(__file__))

    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(pid), "2", coord, meshkind],
            env=env, cwd=os.path.dirname(here),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=420)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        return None  # caller retries once, then fails
    return list(zip(procs, outs))


@pytest.mark.parametrize("meshkind", ["data", "dcn_ici"])
def test_two_process_fake_pod(tmp_path, meshkind):
    results = _run_pod(tmp_path, meshkind)
    if results is None:  # one retry for a slow cold bring-up, then FAIL
        results = _run_pod(tmp_path, meshkind)
    assert results is not None, "multi-process bring-up timed out twice"
    for i, (p, out) in enumerate(results):
        assert p.returncode == 0, f"proc {i} failed:\n{out}"
        assert f"proc {i} OK {meshkind}" in out
