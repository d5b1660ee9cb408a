"""Multi-chip sharding of the phase workload.

The reference's parallelism is OpenMP over genomic chunks
(phase.c:276-279); chunks are independent except for the stitching seam
vote (SURVEY.md §2.3). The device mapping:

  - mesh axes ("dp", "sp"): "dp" shards chunks / read groups (data
    parallel); "sp" shards the pair batch *within* a chunk (the
    sequence-parallel axis — a chunk's thousands of (read x allele) pairs
    split across chips).
  - Every chip runs the same batched pair-HMM scan on its shard.
  - The stitching vote is a `psum` of per-chip (cis, trans) counts over
    both axes — the only cross-chip communication, riding ICI.

`phase_step_sharded` is the jittable multi-chip step the driver
dry-run-compiles; it is also the building block for the production
multi-host scheduler.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from margin_tpu.ops import pairhmm


def make_mesh(n_devices: int | None = None, dp: int | None = None) -> Mesh:
    """2D (dp, sp) mesh over the available devices."""
    devices = np.array(jax.devices())
    n = n_devices or len(devices)
    devices = devices[:n]
    if dp is None:
        # favor the dp axis; sp gets the residual power of two
        dp = max(d for d in range(1, n + 1) if n % d == 0 and d * d <= n * 2)
    sp = n // dp
    return Mesh(devices[:dp * sp].reshape(dp, sp), ("dp", "sp"))


def shard_batch(batch: pairhmm.PairBatch, mesh: Mesh) -> pairhmm.PairBatch:
    """Place a PairBatch with its leading (pair) axis sharded over the whole
    mesh."""
    spec = P(("dp", "sp"))
    shard = NamedSharding(mesh, spec)
    put = lambda x: jax.device_put(x, shard) if x is not None else None
    return pairhmm.PairBatch(
        put(batch.xs), put(batch.ys), put(batch.lxs), put(batch.lys),
        put(batch.strands), put(batch.ragged_left), put(batch.ragged_right),
        put(batch.rep_x), put(batch.rep_y))


def phase_step_sharded(mesh: Mesh, n_slots: int):
    """Returns a jitted multi-chip phase step:

    (tables, batch, slot_idx) ->
        (per-pair allele-support scores, global per-slot support sums)

    The batch's pair axis is sharded over the full mesh. `slot_idx` labels
    each pair with its (bubble, allele) accumulation slot; the per-slot
    sums are reduced across chips with `psum` — the production collective:
    when a bubble's (read x allele) pairs are scattered over shards, its
    total allele supports (the inputs to the read-partition HMM emissions)
    are assembled on every chip without a host gather.
    """
    import warnings
    with warnings.catch_warnings():
        # the jax>=0.8 jax.shard_map API additionally requires pvary
        # annotations on scan carries inside the sharded region; the
        # deprecated entry point still applies the legacy typing rules
        warnings.simplefilter("ignore", DeprecationWarning)
        from jax.experimental.shard_map import shard_map

    def step(tables, batch, slot_idx):
        scores = pairhmm.forward_total(tables, batch)
        local = jax.ops.segment_sum(scores, slot_idx, num_segments=n_slots)
        slot_sums = jax.lax.psum(local, ("dp", "sp"))
        return scores, slot_sums

    sharded = shard_map(
        step, mesh=mesh,
        in_specs=(P(), P(("dp", "sp")), P(("dp", "sp"))),
        out_specs=(P(("dp", "sp")), P()),
        check_rep=False)
    return jax.jit(sharded)
