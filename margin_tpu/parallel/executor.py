"""Process-global device execution context: single chip or a device mesh.

SURVEY §2.3: the reference's only parallelism is OpenMP over genomic chunks
(phase.c:276-279, polish.c:475-478). The JAX mapping keeps chunk
orchestration on host threads and shards the *device work* — the dense
pair-HMM scoring batches that every chunk's bubble construction, het-group
scoring and filtered-read partitioning produce — across a
("dp", "sp") `jax.sharding.Mesh`:

  * every scoring batch's pair axis is split over all mesh devices with
    `shard_map` (same kernel, one shard per chip);
  * the gather of per-pair scores back to the host (the allele-support
    assembly feeding the read-partition HMM) is the only collective, an
    all-gather riding ICI;
  * per-slot reductions (`score_slot_sums`) psum across the mesh so
    multi-host deployments can assemble bubble allele supports without
    a host gather.

The context is process-global and explicitly enabled by the drivers
(`enable_mesh()`): with one device, or before enabling, every call is the
plain single-device jit path, byte-identical to the sharded one.
"""

from __future__ import annotations

import threading
import time
import warnings
from typing import Optional

import numpy as np

from margin_tpu.ops import pairhmm


class DeviceStats:
    """Cheap global accounting of device launches for the bench/profiler:
    launches, pair/cell counts, and wall seconds the host spent blocked on
    device readbacks (an upper bound on device-busy time; the profiler
    trace gives the real one)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.launches = 0
        self.pairs = 0
        self.cells = 0          # padded B*D*W cell-lanes actually computed
        self.wait_s = 0.0

    def add(self, pairs: int, cells: int, wait_s: float):
        with self._lock:
            self.launches += 1
            self.pairs += pairs
            self.cells += cells
            self.wait_s += wait_s

    def snapshot(self) -> dict:
        with self._lock:
            return {"launches": self.launches, "pairs": self.pairs,
                    "cells": self.cells, "device_wait_s": round(self.wait_s, 3)}

    def reset(self):
        with self._lock:
            self.launches = 0
            self.pairs = 0
            self.cells = 0
            self.wait_s = 0.0


DEVICE_STATS = DeviceStats()


def _shard_map():
    with warnings.catch_warnings():
        # jax>=0.8 jax.shard_map requires pvary annotations on scan carries;
        # the legacy entry point still applies the old typing rules
        warnings.simplefilter("ignore", DeprecationWarning)
        from jax.experimental.shard_map import shard_map
    return shard_map


class DeviceContext:
    """Scoring executor. mesh=None -> single-device; `pinned` keeps the
    drivers from installing a mesh over several visible devices."""

    def __init__(self, mesh=None, pinned: bool = False):
        self.mesh = mesh
        self.pinned = pinned
        self._fns = {}
        self._lock = threading.Lock()

    @property
    def n_shards(self) -> int:
        return int(self.mesh.devices.size) if self.mesh is not None else 1

    def _forward_fn(self, use_lut: bool):
        import jax
        from jax.sharding import PartitionSpec as P
        key = ("fwd", use_lut)
        with self._lock:
            fn = self._fns.get(key)
            if fn is None:
                def step(tables, batch):
                    return pairhmm.forward_total(tables, batch,
                                                 use_lut=use_lut)
                fn = jax.jit(_shard_map()(
                    step, mesh=self.mesh,
                    in_specs=(P(), P(("dp", "sp"))),
                    out_specs=P(("dp", "sp")), check_rep=False))
                self._fns[key] = fn
        return fn

    def _slot_fn(self, use_lut: bool, n_slots: int):
        import jax
        from jax.sharding import PartitionSpec as P
        key = ("slots", use_lut, n_slots)
        with self._lock:
            fn = self._fns.get(key)
            if fn is None:
                def step(tables, batch, slot_idx):
                    scores = pairhmm.forward_total(tables, batch,
                                                   use_lut=use_lut)
                    local = jax.ops.segment_sum(scores, slot_idx,
                                                num_segments=n_slots)
                    return scores, jax.lax.psum(local, ("dp", "sp"))
                fn = jax.jit(_shard_map()(
                    step, mesh=self.mesh,
                    in_specs=(P(), P(("dp", "sp")), P(("dp", "sp"))),
                    out_specs=(P(("dp", "sp")), P()), check_rep=False))
                self._fns[key] = fn
        return fn

    def score_batch(self, tables, batch: pairhmm.PairBatch,
                    use_lut: bool = False) -> np.ndarray:
        """Total forward log-probs for a batch; sharded over the mesh when
        one is configured. Returns a host (B,) float array."""
        t0 = time.perf_counter()
        if self.mesh is None:
            out = np.asarray(
                pairhmm.forward_total(tables, batch, use_lut=use_lut))
        else:
            b0 = batch.xs.shape[0]
            batch = pad_batch(batch, self.n_shards)
            out = np.asarray(self._forward_fn(use_lut)(tables, batch))[:b0]
        b, lx = batch.xs.shape
        ly = batch.ys.shape[1]
        DEVICE_STATS.add(b, b * (lx + ly) * (ly + 1),
                         time.perf_counter() - t0)
        return out

    def score_slot_sums(self, tables, batch: pairhmm.PairBatch, slot_idx,
                        n_slots: int, use_lut: bool = False):
        """(per-pair scores, psum'd per-slot score sums). Single-device
        falls back to a host segment sum."""
        if self.mesh is None:
            scores = np.asarray(
                pairhmm.forward_total(tables, batch, use_lut=use_lut))
            sums = np.zeros(n_slots, dtype=scores.dtype)
            np.add.at(sums, np.asarray(slot_idx), scores)
            return scores, sums
        b0 = batch.xs.shape[0]
        batch = pad_batch(batch, self.n_shards)
        pad_n = batch.xs.shape[0] - b0
        if pad_n:
            # padded lanes are length-0 problems scoring LOG_ONE == 0; park
            # them in slot 0 — score 0 adds nothing to the sum
            slot_idx = np.concatenate(
                [np.asarray(slot_idx, np.int32),
                 np.zeros(pad_n, np.int32)])
        scores, sums = self._slot_fn(use_lut, n_slots)(
            tables, batch, np.asarray(slot_idx, np.int32))
        return np.asarray(scores)[:b0], np.asarray(sums)


def pad_batch(batch: pairhmm.PairBatch, multiple: int) -> pairhmm.PairBatch:
    """Pad the pair axis to a multiple of the mesh size with empty
    (length-0) problems."""
    b = batch.xs.shape[0]
    rem = (-b) % multiple
    if rem == 0:
        return batch
    import jax.numpy as jnp

    def pad(a, fill):
        if a is None:
            return None
        pad_block = jnp.full((rem,) + a.shape[1:], fill, a.dtype)
        return jnp.concatenate([a, pad_block])

    return pairhmm.PairBatch(
        pad(batch.xs, 4), pad(batch.ys, 4), pad(batch.lxs, 0),
        pad(batch.lys, 0), pad(batch.strands, 0),
        pad(batch.ragged_left, False), pad(batch.ragged_right, False),
        pad(batch.rep_x, 0), pad(batch.rep_y, 0))


_CTX = DeviceContext()


def context() -> DeviceContext:
    return _CTX


def enable_mesh(n_devices: Optional[int] = None, log=None) -> bool:
    """Install a mesh-sharded context over the visible devices. Returns
    True if a multi-device mesh was installed."""
    global _CTX
    import jax

    from margin_tpu.parallel import mesh as meshmod
    n = n_devices or jax.device_count()
    if n <= 1:
        _CTX = DeviceContext()
        return False
    mesh = meshmod.make_mesh(n)
    _CTX = DeviceContext(mesh)
    if log is not None:
        log(f"> Device mesh: {dict(zip(mesh.axis_names, mesh.devices.shape))} "
            f"over {mesh.devices.size} {jax.default_backend()} devices")
    return True


def disable_mesh(pin: bool = False) -> None:
    """Back to the single-device context; pin=True keeps it there even
    when several devices are visible (the one-card reference run)."""
    global _CTX
    _CTX = DeviceContext(pinned=pin)


def score_batch(tables, batch, use_lut: bool = False) -> np.ndarray:
    return _CTX.score_batch(tables, batch, use_lut=use_lut)


def score_slot_sums(tables, batch, slot_idx, n_slots: int,
                    use_lut: bool = False):
    return _CTX.score_slot_sums(tables, batch, slot_idx, n_slots,
                                use_lut=use_lut)


# ---------------------------------------------------------------------------
# Cross-thread launch coalescing
# ---------------------------------------------------------------------------

class _ScoreRequest:
    __slots__ = ("tables", "pairs", "strands", "reps", "use_lut",
                 "batch_max", "out", "done", "error")

    def __init__(self, tables, pairs, strands, reps, use_lut, batch_max):
        self.tables = tables
        self.pairs = pairs
        self.strands = strands
        self.reps = reps
        self.use_lut = use_lut
        self.batch_max = batch_max
        self.out = np.empty(len(pairs), dtype=np.float32)
        self.done = False
        self.error = None

    def key(self):
        return (id(self.tables), self.use_lut, self.reps is not None)


class _PairScoreService:
    """Combining funnel for pair-scoring requests.

    The phase/polish drivers run chunks on host threads (phase.c:276-279);
    each chunk issues several scoring batches against the one accelerator.
    Launching them independently serializes on the device *and* pays the
    fixed dispatch/readback toll per launch. This service merges requests
    that queue up while a launch is in flight into the next launch: the
    thread that finds the device free becomes the dispatcher, drains every
    compatible queued request, scores them as one concatenated batch and
    distributes results. Per-pair scores are bit-identical to unbatched
    calls — a lane's DP never reads another lane, and make_batch padding
    is masked out of every cell (forward_total harvests each pair at its
    own lx+ly) — so coalescing cannot change any output.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue = []
        self._busy = False

    def score(self, tables, pairs, strands, reps, use_lut, batch_max):
        req = _ScoreRequest(tables, list(pairs), strands, reps, use_lut,
                            batch_max)
        if not req.pairs:
            return req.out
        with self._cond:
            self._queue.append(req)
            while not req.done:
                if self._busy:
                    # a launch is in flight; our request stays queued so the
                    # next dispatcher picks it up
                    self._cond.wait()
                    continue
                mine = [r for r in self._queue if r.key() == req.key()]
                self._queue = [r for r in self._queue
                               if r.key() != req.key()]
                self._busy = True
                self._cond.release()  # let other threads enqueue mid-launch
                try:
                    self._run(mine)
                finally:
                    self._cond.acquire()
                    self._busy = False
                    for r in mine:
                        r.done = True
                    self._cond.notify_all()
        if req.error is not None:
            raise req.error
        return req.out

    def _run(self, reqs):
        """Score the union of `reqs` (all same key) in as few launches as
        possible. Runs with the funnel lock released: the device call blocks
        this thread while fresh requests accumulate in the queue for the
        next dispatch round."""
        try:
            tables = reqs[0].tables
            use_lut = reqs[0].use_lut
            use_rle = reqs[0].reps is not None
            batch_max = min(r.batch_max for r in reqs)
            flat = [(ri, i) for ri, r in enumerate(reqs)
                    for i in range(len(r.pairs))]
            flat.sort(key=lambda t: (len(reqs[t[0]].pairs[t[1]][0]),
                                     len(reqs[t[0]].pairs[t[1]][1])))
            for s0 in range(0, len(flat), batch_max):
                part = flat[s0:s0 + batch_max]
                sel_pairs = [reqs[ri].pairs[i] for ri, i in part]
                sel_strands = np.array(
                    [reqs[ri].strands[i] for ri, i in part], np.int32)
                sel_reps = ([reqs[ri].reps[i] for ri, i in part]
                            if use_rle else None)
                batch = pairhmm.make_batch(sel_pairs, strands=sel_strands,
                                           rep_pairs=sel_reps)
                scores = _CTX.score_batch(tables, batch, use_lut=use_lut)
                for (ri, i), s in zip(part, scores):
                    reqs[ri].out[i] = s
        except BaseException as e:  # surface on every waiter
            for r in reqs:
                r.error = e


_SCORER = _PairScoreService()
_IPC_CLIENT = None


def install_ipc_client(client) -> None:
    """Route score_pairs over an IPC connection to a device-owning parent
    process (margin_tpu.parallel.ipc). Worker-process mode only."""
    global _IPC_CLIENT
    _IPC_CLIENT = client


def has_ipc_client() -> bool:
    return _IPC_CLIENT is not None


def score_pairs(tables, pairs, strands, rep_pairs=None, use_lut: bool = False,
                batch_max: int = 32768) -> np.ndarray:
    """Score a list of (x_sym, y_sym) pairs, coalescing concurrent callers
    into shared device launches. Returns (len(pairs),) float32 scores in
    request order."""
    if _IPC_CLIENT is not None and len(pairs) > 0:
        return _IPC_CLIENT.score(tables, pairs, strands, rep_pairs, use_lut,
                                 batch_max)
    return _SCORER.score(tables, pairs, strands, rep_pairs, use_lut,
                         batch_max)


def ipc_banded(tables, items, expansion, threshold, use_lut, dynamic):
    """Worker-process path for banded_posteriors_many: ship the batch to
    the device-owning parent, whose cross-chunk funnel merges concurrent
    workers' batches into shared full-lane launches."""
    return _IPC_CLIENT.banded(tables, items, expansion, threshold, use_lut,
                              dynamic)
