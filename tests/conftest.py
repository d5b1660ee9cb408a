"""Test configuration: the CPU backend with an 8-device virtual mesh, x64
for the double-precision oracle comparisons, and the in-repo inputs.

Inputs: `PARAMS` is the checked-in parameter file
(margin_tpu/testing/params/ont_sim.json); `sim_phase` and `sim_polish`
are small seeded datasets (margin_tpu.testing.simulate) written once per
session. `reference_path` names files of the upstream project's test tree,
which this repository does not carry; tests that need them are marked
slow."""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from margin_tpu.testing.simulate import PARAMS_PATH  # noqa: E402
from margin_tpu.utils import compile_cache  # noqa: E402

compile_cache.configure()

PARAMS = PARAMS_PATH
UPSTREAM = os.environ.get("MARGIN_UPSTREAM_DIR", "upstream-margin")


def reference_path(*parts):
    """A file of the upstream Margin checkout (MARGIN_UPSTREAM_DIR)."""
    return os.path.join(UPSTREAM, *parts)


def _dataset(tmp_path_factory, kind, **kw):
    from margin_tpu.testing import simulate

    make = (simulate.phase_dataset if kind == "phase"
            else simulate.polish_dataset)
    out = tmp_path_factory.mktemp(f"sim_{kind}")
    paths = simulate.write_dataset(make(**kw), str(out))
    paths["params"] = PARAMS
    return paths


@pytest.fixture(scope="session")
def sim_phase(tmp_path_factory):
    """A 120 kb phase dataset at 30x (two chunks)."""
    return _dataset(tmp_path_factory, "phase", seed=3, span=120_000,
                    depth=30)


@pytest.fixture(scope="session")
def sim_polish(tmp_path_factory):
    """A 12 kb polish dataset at 30x."""
    return _dataset(tmp_path_factory, "polish", seed=4, span=12_000,
                    depth=30, draft_error_rate=0.01)
