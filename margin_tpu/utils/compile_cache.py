"""Where JAX keeps compiled executables between processes.

If `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and nothing
here changes it. Otherwise the cache lives in one fixed directory inside
the checkout, `.jax_cache/` (listed in .gitignore): `.jax_cache/gpu` for
the GPU backend, and for XLA:CPU a subdirectory keyed by the host's CPU
features, because an XLA:CPU executable compiled for other CPU features
can crash when loaded.
"""

from __future__ import annotations

import hashlib
import os
import platform

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_ROOT = os.path.join(CHECKOUT, ".jax_cache")


def _cpu_tag() -> str:
    sig = platform.machine()
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith("flags"):
                    return sig + "-" + hashlib.md5(
                        line.encode()).hexdigest()[:10]
    except OSError:
        pass
    return sig


def cache_dir(backend: str, environ=None) -> str:
    """The cache directory for `backend` ("cpu", "gpu", ...)."""
    environ = os.environ if environ is None else environ
    env = environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    sub = f"cpu-{_cpu_tag()}" if backend == "cpu" else backend
    return os.path.join(DEFAULT_ROOT, sub)


def configure() -> str:
    """Point JAX's persistent cache at `cache_dir` for the default backend
    (call after choosing the platform, before compiling). Returns the
    directory."""
    import jax

    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return os.environ["JAX_COMPILATION_CACHE_DIR"]
    d = cache_dir(jax.default_backend())
    jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return d
