"""Structured per-chunk / per-stage timing (SURVEY §5 tracing row).

The reference only has ad-hoc wall-clock prints (phase.c:309-321,
polish.c:508-518, getTimeDescriptorFromSeconds misc.c:13). This build
replaces those with a structured profiler: every pipeline stage and every
chunk records wall seconds into a JSON document, and an optional JAX
profiler trace can wrap the whole run for xprof-style analysis.

Usage:
    prof = Profiler(enabled=True)
    with prof.stage("vcf_parse"): ...
    with prof.chunk_stage(chunk_idx, "readextract"): ...
    prof.write("out.profile.json")

Thread-safe: chunk records may be written from a worker pool.
"""

from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from typing import Dict, Optional


class Profiler:
    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._t0 = time.time()
        self.stages: Dict[str, float] = {}
        self.counters: Dict[str, float] = {}
        self.chunks: Dict[int, Dict[str, float]] = {}

    @contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        t = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t
            with self._lock:
                self.stages[name] = self.stages.get(name, 0.0) + dt

    @contextmanager
    def chunk_stage(self, chunk_idx: int, name: str):
        if not self.enabled:
            yield
            return
        t = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t
            with self._lock:
                rec = self.chunks.setdefault(chunk_idx, {})
                rec[name] = rec.get(name, 0.0) + dt

    def count(self, name: str, value: float = 1.0):
        if not self.enabled:
            return
        with self._lock:
            self.counters[name] = self.counters.get(name, 0.0) + value

    def summary(self) -> dict:
        """Aggregate: total wall, per-stage totals, per-chunk-stage sums."""
        chunk_stage_totals: Dict[str, float] = {}
        for rec in self.chunks.values():
            for k, v in rec.items():
                chunk_stage_totals[k] = chunk_stage_totals.get(k, 0.0) + v
        return {
            "wall_s": round(time.time() - self._t0, 3),
            "stages_s": {k: round(v, 3) for k, v in self.stages.items()},
            "chunk_stage_totals_s": {k: round(v, 3)
                                     for k, v in chunk_stage_totals.items()},
            "counters": self.counters,
            "n_chunks": len(self.chunks),
            "chunks": {str(k): {s: round(v, 4) for s, v in rec.items()}
                       for k, rec in sorted(self.chunks.items())},
        }

    def write(self, path: str):
        if not self.enabled:
            return
        with open(path, "w") as fh:
            json.dump(self.summary(), fh, indent=1)

    def merge_file(self, path: str):
        """Fold a worker process's written profile into this one: chunk
        stages and counters add directly; the worker's own pipeline stages
        (its per-process setup) land under a `workers_` prefix. This closes
        the `--workers process` observability hole — without it, per-chunk
        stage timing vanished across the process boundary and
        chunk_stage_totals_s came back empty."""
        if not self.enabled:
            return
        try:
            with open(path) as fh:
                doc = json.load(fh)
        except (OSError, ValueError):
            return
        with self._lock:
            for k, rec in doc.get("chunks", {}).items():
                dst = self.chunks.setdefault(int(k), {})
                for s, v in rec.items():
                    dst[s] = dst.get(s, 0.0) + v
            for k, v in doc.get("counters", {}).items():
                self.counters[k] = self.counters.get(k, 0.0) + v
            for k, v in doc.get("stages_s", {}).items():
                key = f"workers_{k}"
                self.stages[key] = self.stages.get(key, 0.0) + v

    def log_summary(self, log=print):
        if not self.enabled:
            return
        s = self.summary()
        top = sorted(s["chunk_stage_totals_s"].items(), key=lambda kv: -kv[1])
        parts = ", ".join(f"{k} {v:.2f}s" for k, v in top[:8])
        log(f"> Profile: wall {s['wall_s']}s; chunk stages: {parts}")
        top2 = sorted(s["stages_s"].items(), key=lambda kv: -kv[1])
        parts2 = ", ".join(f"{k} {v:.2f}s" for k, v in top2[:8])
        log(f"> Profile: pipeline stages: {parts2}")


NULL = Profiler(enabled=False)


@contextmanager
def maybe_jax_trace(trace_dir: Optional[str]):
    """Wrap a block in a JAX profiler trace when a directory is given
    (SURVEY §5: ad-hoc timers -> structured timing + xprof hooks)."""
    if not trace_dir:
        yield
        return
    import jax
    with jax.profiler.trace(trace_dir):
        yield
