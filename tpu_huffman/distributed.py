"""Multi-process bring-up and global-array plumbing for MeshCodec.

The reference has no distribution layer at all (single process, SURVEY.md
§2.2); this module is the framework's distribution seam, built on JAX's
native runtime: `jax.distributed.initialize` for process bring-up, a global
device mesh spanning all processes (XLA hands its collectives to NCCL on
GPUs), and process-local ↔ global array conversion so each process feeds
only its shard of the byte stream.

Usage with N processes (same program in every process):

    import tpu_huffman as th
    from tpu_huffman import distributed as dist

    dist.initialize("host0:1234", num_processes=N, process_id=i)
    mesh = dist.global_data_mesh()         # 1-D mesh over all devices
    codec = th.MeshCodec(table, mesh)

    encoded, index = dist.encode_global(codec, my_process_bytes)
    # encoded/index are replicated to every process (small relative to
    # input when used for storage; for pure compression pipelines keep
    # outputs device-resident instead).

One process can also drive every card of a machine: ``th.default_mesh()``
is the 1-D mesh over the local devices. Testing without a cluster:
tests/test_distributed.py launches two CPU processes with 4 virtual
devices each (the "fake pod" tier from SURVEY.md §4 that the reference
lacks).
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               local_device_ids=None) -> None:
    """Bring up the JAX distributed runtime (idempotent).

    Pass the coordinator address (``host:port``), the process count and
    this process's id; with no arguments JAX reads them from a cluster
    environment it recognizes, and fails where there is none.
    """
    if jax.process_count() > 1 or getattr(initialize, "_done", False):
        return
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    if local_device_ids is not None:
        kwargs["local_device_ids"] = local_device_ids
    jax.distributed.initialize(**kwargs)
    initialize._done = True


def global_data_mesh(axis: str = "data") -> Mesh:
    """1-D mesh over every device of every process."""
    return Mesh(np.asarray(jax.devices()), (axis,))


def process_local_mesh() -> Mesh:
    """2-D (processes × local devices) mesh, process-major: MeshCodec
    flattens it to one data axis in process order."""
    n_proc = jax.process_count()
    per = jax.local_device_count()
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    return Mesh(np.asarray(devs).reshape(n_proc, per), ("process", "local"))


def encode_global(codec, local_data: bytes):
    """Data-parallel encode where each process contributes its own bytes.

    All processes must call this collectively. The raw input is NEVER
    gathered: each host feeds only its local shard via
    ``jax.make_array_from_process_local_data``; the only cross-host
    traffic is the per-shard bit totals (tiny), the compressed output
    words, and the O(blocks) offset index (see MeshCodec.encode_sharded).
    Shard lengths may differ across hosts. Returns (encoded_bytes,
    BlockIndex) replicated on every process; the bytes are bit-identical
    to the single-stream encoding of the hosts' data concatenated in
    process order.
    """
    return codec.encode_sharded(local_data)


def decode_global(codec, encoded: bytes, index):
    """Collective decode; every process returns the full plaintext."""
    return codec.decode(encoded, index)
