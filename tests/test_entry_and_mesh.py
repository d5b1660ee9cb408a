"""Driver entry points + multi-chip sharding dry runs on the virtual CPU
mesh."""

import os
import sys

import jax
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import __graft_entry__ as graft  # noqa: E402


def test_entry_compiles_and_runs():
    fn, args = graft.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (256,)
    assert np.all(np.isfinite(np.asarray(out)))


def test_dryrun_multichip_8():
    graft.dryrun_multichip(8)


def test_dryrun_multichip_2(monkeypatch):
    # the diploid-polish level is exercised by the 8-device dryrun above;
    # running it twice pushed the fast suite against its wall budget
    monkeypatch.setenv("MARGIN_TPU_DRYRUN_NO_DIPLOID", "1")
    graft.dryrun_multichip(2)


def test_sharded_scores_match_single_device():
    """The sharded phase step must produce identical scores to the
    single-device kernel."""
    from margin_tpu.ops import pairhmm
    from margin_tpu.parallel import mesh as meshmod
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    tables, batch = graft._example_tables_and_batch(n_pairs=64, lx=10, ly=12)
    expected = np.asarray(pairhmm.forward_total(tables, batch))

    mesh = meshmod.make_mesh(8)
    sharded_batch = meshmod.shard_batch(batch, mesh)
    slot_idx = jax.device_put(jnp.arange(64, dtype=jnp.int32) % 4,
                              NamedSharding(mesh, P(("dp", "sp"))))
    step = meshmod.phase_step_sharded(mesh, 4)
    scores, slot_sums = step(tables, sharded_batch, slot_idx)
    np.testing.assert_allclose(np.asarray(scores), expected, rtol=0, atol=1e-5)
    # global per-slot reduction equals the host-side segment sums
    host = np.zeros(4)
    for i, s in enumerate(expected):
        host[i % 4] += s
    np.testing.assert_allclose(np.asarray(slot_sums), host, rtol=1e-6)


def test_score_pairs_coalescing_matches_sequential():
    """executor.score_pairs: concurrent requests coalesced into shared
    launches must return bit-identical scores to per-request scoring, in
    request order, and partial/mixed batch_max values must be honored."""
    from concurrent.futures import ThreadPoolExecutor

    from margin_tpu.ops import pairhmm
    from margin_tpu.parallel import executor

    rng = np.random.default_rng(7)
    tables, _ = graft._example_tables_and_batch(n_pairs=1)

    def make_request(seed, n):
        r = np.random.default_rng(seed)
        pairs = [(r.integers(0, 4, int(r.integers(3, 24))).astype(np.uint8),
                  r.integers(0, 4, int(r.integers(3, 28))).astype(np.uint8))
                 for _ in range(n)]
        strands = [int(s) for s in r.integers(0, 2, n)]
        return pairs, strands

    reqs = [make_request(100 + i, int(rng.integers(5, 40)))
            for i in range(12)]
    # sequential ground truth through the plain batch path
    expected = []
    for pairs, strands in reqs:
        batch = pairhmm.make_batch(pairs,
                                   strands=np.asarray(strands, np.int32))
        expected.append(np.asarray(pairhmm.forward_total(tables, batch),
                                   np.float32)[:len(pairs)])

    with ThreadPoolExecutor(max_workers=6) as pool:
        outs = list(pool.map(
            lambda pr: executor.score_pairs(tables, pr[0], pr[1],
                                            batch_max=64),
            reqs))
    for got, want in zip(outs, expected):
        np.testing.assert_array_equal(got, want)

    # empty request short-circuits
    assert executor.score_pairs(tables, [], []).shape == (0,)


def test_executor_mesh_scores_match():
    """parallel.executor: the mesh-sharded scoring context must return the
    single-device scores for arbitrary batch sizes (incl. pad lanes)."""
    from margin_tpu.parallel import executor

    tables, batch = graft._example_tables_and_batch(n_pairs=49, lx=9, ly=11)
    single = executor.score_batch(tables, batch)
    try:
        assert executor.enable_mesh(8)
        meshed = executor.score_batch(tables, batch)[:len(single)]
        np.testing.assert_allclose(meshed, single, rtol=0, atol=1e-5)
        scores, sums = executor.score_slot_sums(
            tables, batch, np.arange(batch.xs.shape[0]) % 3, 3)
        host = np.zeros(3)
        for i, s in enumerate(single):
            host[i % 3] += s
        np.testing.assert_allclose(sums, host, rtol=1e-6)
    finally:
        executor.disable_mesh()


def test_dryrun_self_sufficient_platform_forcing():
    """dryrun_multichip must build the n-device virtual CPU mesh in a bare
    interpreter: strip XLA_FLAGS/JAX_PLATFORMS to prove the function
    forces it itself."""
    import os
    import subprocess

    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["MARGIN_TPU_DRYRUN_KERNEL_ONLY"] = "1"
    r = subprocess.run(
        [sys.executable, "-c",
         "import __graft_entry__ as g; g.dryrun_multichip(8); print('OK')"],
        cwd=REPO, capture_output=True, text=True, timeout=240,
        env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "OK" in r.stdout
