"""Multi-host scale-out: jax.distributed process group + collective gather
of per-chunk stitch summaries.

SURVEY §2.3 / §7.8: the reference is single-host OpenMP; the only
inter-chunk state its merge needs is tiny per-chunk summaries (read-name
hap maps + switch flags, stitching.c:1573-1588). The scale-out here
therefore keeps hosts embarrassingly parallel — params/reference replicated,
the BAM chunk stream partitioned by chunk index — and uses exactly one
collective: an all-gather of serialized chunk results riding the global
process group, after which every host holds the full result set
and host 0 writes outputs.

Usage (one process per host, same command line everywhere):

    margin_tpu phase ... --hosts N --host-id I --coordinator HOST:PORT

Each process drives its own card, so on one machine `--hosts N` needs N
cards (one process per card); the 2-process CPU test
(tests/test_multihost.py) asserts byte-identical outputs vs a
single-process run.
"""

from __future__ import annotations

import pickle
from typing import List, Optional

import numpy as np

_INITIALIZED = False


def init(coordinator: str, num_hosts: int, host_id: int) -> None:
    """jax.distributed.initialize — idempotent."""
    global _INITIALIZED
    if _INITIALIZED:
        return
    import jax
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_hosts,
                               process_id=host_id)
    _INITIALIZED = True


def allgather_bytes(payload: bytes) -> List[bytes]:
    """All-gather one variable-length byte string per host: a two-phase
    (lengths, padded data) gather over the global backend. Every host
    returns the same ordered list (index == host id)."""
    from jax.experimental import multihost_utils

    n = np.array([len(payload)], dtype=np.int64)
    lens = np.asarray(multihost_utils.process_allgather(n)).reshape(-1)
    m = int(lens.max()) if lens.size else 0
    buf = np.zeros(max(m, 1), dtype=np.uint8)
    if payload:
        buf[:len(payload)] = np.frombuffer(payload, dtype=np.uint8)
    data = np.asarray(multihost_utils.process_allgather(buf))
    return [data[i, :int(lens[i])].tobytes() for i in range(len(lens))]


def allgather_objects(obj) -> List:
    """All-gather one picklable object per host."""
    return [pickle.loads(b) for b in allgather_bytes(
        pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))]


def dumps_z(obj) -> bytes:
    """Compressed wire encoding for the stitch-summary gathers: pickled
    then zlib level 1. The payload content is already semantically minimal
    (read-name hap maps, switch flags, consensus sequences — exactly the
    stitching.c:1573-1588 merge inputs); compression removes the pickle +
    text redundancy (~5-6x on sequence-heavy chunk records), which at
    whole-genome chunk counts is the difference between MBs and tens of
    MBs per host on the wire."""
    import zlib
    return b"Z1" + zlib.compress(
        pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL), 1)


def loads_z(b: bytes):
    """Inverse of dumps_z; transparently accepts uncompressed pickles
    (older peers / tests)."""
    import zlib
    if b[:2] == b"Z1":
        return pickle.loads(zlib.decompress(b[2:]))
    return pickle.loads(b)


def host_id() -> int:
    import jax
    return jax.process_index()


def num_hosts() -> int:
    import jax
    return jax.process_count()


def barrier(name: str = "margin") -> None:
    from jax.experimental import multihost_utils
    multihost_utils.sync_global_devices(name)
