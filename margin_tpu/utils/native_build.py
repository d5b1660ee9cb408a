"""Build-at-first-use for the native host engines under `native/`.

Each engine is a shared library built from its tracked source with
`native/Makefile` on the machine that runs it (the Makefile compiles with
-march=native). A library older than its source is rebuilt. Concurrent
processes (test workers, worker processes) serialize on a file lock, and
a library is loaded only once its build has finished.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import sys
import threading
from typing import Optional

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")

_LOCK = threading.Lock()


def build(name: str) -> Optional[str]:
    """Path of native/lib<name>.so, built first if missing or stale;
    None (with make's output on stderr) if the build fails."""
    so = os.path.join(NATIVE_DIR, f"lib{name}.so")
    src = os.path.join(NATIVE_DIR, f"{name}.cc")

    def fresh():
        return (os.path.exists(so)
                and os.path.getmtime(so) >= os.path.getmtime(src))

    # the lock is taken even when the library looks fresh: another
    # process may be writing it right now
    with _LOCK, open(os.path.join(NATIVE_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if fresh():
            return so
        proc = subprocess.run(
            ["make", "-C", NATIVE_DIR, f"lib{name}.so"],
            capture_output=True, text=True, timeout=600,
            env=dict(os.environ, JAX_PLATFORMS="cpu"))
        if proc.returncode != 0 or not fresh():
            print(f"margin_tpu: building native/lib{name}.so failed:\n"
                  f"{proc.stdout}{proc.stderr}", file=sys.stderr)
            return None
    return so


def load(name: str) -> Optional[ctypes.CDLL]:
    """Build (if needed) and load native/lib<name>.so; None if either
    fails."""
    so = build(name)
    if so is None:
        return None
    try:
        return ctypes.CDLL(so)
    except OSError as e:
        print(f"margin_tpu: loading {so} failed: {e}", file=sys.stderr)
        return None
