"""Cross-process scoring service: host workers feed one device owner.

The reference parallelizes chunks with OpenMP threads sharing one address
space (phase.c:276-279). A Python host is GIL-bound, so chunk workers here
are *processes*; the accelerator, though, can only be attached to one
process. This module is the bridge — the device-side analogue of htslib's
hts_tpool host pipeline (htsIntegration.c:256-265) crossed with a device
server:

  * the parent (device owner) runs a `ScoreServer`: a unix-socket listener
    whose per-worker handler threads push scoring requests into
    `executor.score_pairs`, where the combining funnel merges concurrent
    workers' requests into shared device launches;
  * each worker process runs the whole chunk pipeline on CPU
    (JAX_PLATFORMS=cpu; it never takes the card) with `executor` routing
    `score_pairs` over the socket;
  * chunk results travel through the existing shard checkpoint directory,
    and the parent finishes with the ordinary `--shard merge` pass, so
    process mode is byte-identical to `-t N` thread mode (both use the
    per-chunk-seeded RNG streams).

Transport is `multiprocessing.connection` (pickled numpy) over AF_UNIX with
a random authkey; requests are a few MB per chunk stage, far below socket
throughput.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import tempfile
import threading
from typing import Dict, List, Optional

import numpy as np


def _tables_payload(tables) -> dict:
    """PairHmmTables -> plain numpy dict (device arrays don't cross
    processes)."""
    return {
        "match": np.asarray(tables.match),
        "gap_x": np.asarray(tables.gap_x),
        "gap_y": np.asarray(tables.gap_y),
        "trans": np.asarray(tables.trans),
        "repeat": None if tables.repeat is None else np.asarray(tables.repeat),
    }


def _tables_digest(payload: dict) -> str:
    h = hashlib.sha256()
    for k in ("match", "gap_x", "gap_y", "trans", "repeat"):
        v = payload[k]
        h.update(k.encode())
        if v is not None:
            h.update(np.ascontiguousarray(v).tobytes())
    return h.hexdigest()


class ScoreServer:
    """Parent-side scoring service over a unix socket."""

    def __init__(self):
        from multiprocessing.connection import Listener
        self._dir = tempfile.mkdtemp(prefix="margin_score_")
        self.address = os.path.join(self._dir, "sock")
        self.authkey = os.urandom(20)
        self._listener = Listener(self.address, family="AF_UNIX",
                                  authkey=self.authkey)
        self._threads: List[threading.Thread] = []
        self._tables_cache: Dict[str, object] = {}
        self._cache_lock = threading.Lock()
        self._stopping = False
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()

    def _accept_loop(self):
        while not self._stopping:
            try:
                conn = self._listener.accept()
            except (OSError, EOFError):
                return
            t = threading.Thread(target=self._serve, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _serve(self, conn):
        from margin_tpu.ops import pairhmm
        from margin_tpu.parallel import executor

        conn_tables: Dict[int, object] = {}
        try:
            while True:
                msg = conn.recv()
                kind = msg[0]
                if kind == "tables":
                    _, key, payload = msg
                    digest = _tables_digest(payload)
                    with self._cache_lock:
                        t = self._tables_cache.get(digest)
                        if t is None:
                            # one shared object per distinct table content:
                            # the score_pairs funnel coalesces by object
                            # identity, so all workers' requests merge.
                            # Arrays stay NUMPY: jit accepts them directly,
                            # and the banded prep's np.asarray(tables.*)
                            # then needs no device readback
                            t = pairhmm.PairHmmTables(
                                np.asarray(payload["match"]),
                                np.asarray(payload["gap_x"]),
                                np.asarray(payload["gap_y"]),
                                np.asarray(payload["trans"]),
                                None if payload["repeat"] is None
                                else np.asarray(payload["repeat"]))
                            self._tables_cache[digest] = t
                    conn_tables[key] = t
                elif kind == "score":
                    _, key, pairs, strands, reps, use_lut, batch_max = msg
                    try:
                        out = executor.score_pairs(
                            conn_tables[key], pairs, strands,
                            rep_pairs=reps, use_lut=use_lut,
                            batch_max=batch_max)
                        conn.send(("ok", out))
                    except BaseException as e:  # ship failure to the worker
                        conn.send(("err", repr(e)))
                elif kind == "banded":
                    # batched banded-FB posteriors: worker chunk pipelines
                    # ship their realign batches here so the accelerator's
                    # cross-chunk pack funnel (ops/banded._FbFunnel) merges
                    # ALL workers' reads into full-lane pipelined launches —
                    # polish.c:475-478's omp-for with the chip kept fed
                    _, key, items, expansion, threshold, use_lut, dyn = msg
                    try:
                        from margin_tpu.ops import banded as _banded
                        # anchors travel as (n, 3) arrays; the solver's
                        # geometry/split paths consume arrays directly
                        out = _banded.banded_posteriors_many(
                            conn_tables[key], items, expansion,
                            threshold=threshold, use_lut=use_lut,
                            dynamic=dyn)
                        conn.send(("ok", out))
                    except BaseException as e:
                        conn.send(("err", repr(e)))
                else:
                    conn.send(("err", f"unknown request {kind!r}"))
        except (EOFError, OSError):
            pass
        finally:
            conn.close()

    def close(self):
        self._stopping = True
        try:
            self._listener.close()
        except Exception:
            pass
        import shutil
        shutil.rmtree(self._dir, ignore_errors=True)

    def env(self) -> dict:
        """Environment variables advertising this server to workers."""
        return {"MARGIN_TPU_SCORE_SERVER": self.address,
                "MARGIN_TPU_SCORE_AUTH": self.authkey.hex()}


# ---------------------------------------------------------------------------
# worker-side client (installed into executor.score_pairs)
# ---------------------------------------------------------------------------

class ScoreClient:
    def __init__(self, address: str, authkey: bytes):
        from multiprocessing.connection import Client
        self._conn = Client(address, family="AF_UNIX", authkey=authkey)
        self._lock = threading.Lock()
        self._sent: Dict[int, bool] = {}

    def score(self, tables, pairs, strands, reps, use_lut, batch_max):
        key = id(tables)
        with self._lock:
            if key not in self._sent:
                self._conn.send(("tables", key, _tables_payload(tables)))
                self._sent[key] = True
            self._conn.send((
                "score", key,
                [(np.asarray(x), np.asarray(y)) for x, y in pairs],
                [int(s) for s in strands],
                None if reps is None else
                [(np.asarray(a), np.asarray(b)) for a, b in reps],
                bool(use_lut), int(batch_max)))
            status, out = self._conn.recv()
        if status != "ok":
            raise RuntimeError(f"score server error: {out}")
        return out

    def banded(self, tables, items, expansion, threshold, use_lut, dynamic):
        """Route a banded_posteriors_many batch to the device-owning
        parent; anchors ship as (n, 3) int64 arrays (cheap pickle)."""
        key = id(tables)
        wire_items = []
        for it in items:
            w = {"x_sym": np.asarray(it["x_sym"]),
                 "y_sym": np.asarray(it["y_sym"]),
                 "anchors": np.asarray(
                     [] if it["anchors"] is None else it["anchors"],
                     dtype=np.int64).reshape(-1, 3),
                 "strand": int(it["strand"])}
            for k in ("rep_x", "rep_y", "ragged_left", "ragged_right"):
                if it.get(k) is not None:
                    w[k] = it[k]
            wire_items.append(w)
        with self._lock:
            if key not in self._sent:
                self._conn.send(("tables", key, _tables_payload(tables)))
                self._sent[key] = True
            self._conn.send(("banded", key, wire_items, int(expansion),
                             float(threshold), bool(use_lut), bool(dynamic)))
            status, out = self._conn.recv()
        if status != "ok":
            raise RuntimeError(f"score server error: {out}")
        return out

    def close(self):
        try:
            self._conn.close()
        except Exception:
            pass


def maybe_install_client() -> bool:
    """Install an IPC scoring client if MARGIN_TPU_SCORE_SERVER is set
    (worker processes spawned by run_process_workers)."""
    addr = os.environ.get("MARGIN_TPU_SCORE_SERVER")
    if not addr:
        return False
    from margin_tpu.parallel import executor
    auth = bytes.fromhex(os.environ.get("MARGIN_TPU_SCORE_AUTH", ""))
    executor.install_ipc_client(ScoreClient(addr, auth))
    return True


# ---------------------------------------------------------------------------
# orchestration
# ---------------------------------------------------------------------------

def run_process_workers(worker_argv: List[str], n_workers: int,
                        output_base: str, resume: bool,
                        log=print, profile: bool = False) -> None:
    """Run `n_workers` CLI subprocesses, each processing shard i/N of the
    chunks into <output_base>.checkpoint/ on the CPU backend with scoring
    routed to this (device-owning) process. Returns when all shards are
    done; the caller then runs the ordinary shard-merge pass. With
    profile=True each worker records its per-chunk stage timings to
    <output_base>.profile.worker<i>.json for the parent to fold back in
    (SURVEY §5: structured per-shard timing must survive the process
    boundary)."""
    if not resume:
        # a stale/partial checkpoint dir would otherwise race the workers'
        # own meta validation at startup
        import shutil
        shutil.rmtree(f"{output_base}.checkpoint", ignore_errors=True)

    server = ScoreServer()
    env = dict(os.environ)
    env.update(server.env())
    # budget each worker's native-FB threads so n_workers pools don't
    # oversubscribe the host
    env.setdefault("MARGIN_TPU_NATIVE_FB_THREADS",
                   str(max(1, (os.cpu_count() or 4) // max(1, n_workers))))
    # same budget for the bulk BGZF inflate pool (marginio BulkRange):
    # n_workers x io_threads must not oversubscribe the host
    env.setdefault("MARGIN_TPU_IO_THREADS",
                   str(max(1, (os.cpu_count() or 4) // max(1, n_workers))))
    # workers never touch a device (one process per card): any stray jax
    # use lands on the CPU backend
    env["JAX_PLATFORMS"] = "cpu"
    env.setdefault("PYTHONPATH", "")
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = (repo_root + (os.pathsep + env["PYTHONPATH"]
                                      if env["PYTHONPATH"] else ""))
    procs = []
    logs = []
    try:
        for i in range(n_workers):
            argv = list(worker_argv) + ["--shard", f"{i}/{n_workers}"]
            wenv = env
            if profile:
                argv += ["--profile"]
                wenv = dict(env)
                wenv["MARGIN_TPU_PROFILE_OUT"] = (
                    f"{output_base}.profile.worker{i}.json")
            # worker output spools to a temp FILE: a shared-parent PIPE
            # read sequentially can fill and deadlock a later worker while
            # the parent waits on an earlier one
            lf = tempfile.TemporaryFile()
            logs.append(lf)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "margin_tpu"] + argv, env=wenv,
                stdout=lf, stderr=subprocess.STDOUT))
        failures = []
        for i, p in enumerate(procs):
            p.wait()
            if p.returncode != 0:
                logs[i].seek(0)
                failures.append((i, p.returncode,
                                 logs[i].read().decode(errors="replace")))
        if failures:
            i, rc, out = failures[0]
            tail = "\n".join(out.splitlines()[-25:])
            raise RuntimeError(
                f"process worker {i} exited with {rc} "
                f"({len(failures)}/{n_workers} failed):\n{tail}")
        log(f"> {n_workers} process workers finished; merging")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for lf in logs:
            lf.close()
        server.close()
