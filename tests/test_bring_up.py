"""Running on a device: the compile-cache location, no silent fall back
to the CPU, the contract of chip_smoke.py without a GPU, and `phase` /
`polish` end to end on simulated data with their truth checks."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from margin_tpu.utils import compile_cache

from conftest import PARAMS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_dir_follows_the_environment():
    env = {"JAX_COMPILATION_CACHE_DIR": "/some/where"}
    assert compile_cache.cache_dir("gpu", env) == "/some/where"
    assert compile_cache.cache_dir("cpu", env) == "/some/where"


def test_cache_dir_default_is_fixed_inside_the_checkout():
    gpu = compile_cache.cache_dir("gpu", {})
    cpu = compile_cache.cache_dir("cpu", {})
    root = os.path.join(REPO, ".jax_cache")
    assert gpu == os.path.join(root, "gpu")
    assert os.path.dirname(cpu) == root and cpu != gpu
    assert cpu == compile_cache.cache_dir("cpu", {})  # stable per host


def _run(args, env_extra, cwd=REPO, timeout=300):
    env = dict(os.environ)
    env.update(env_extra)
    env["PYTHONPATH"] = REPO
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_configure_sets_the_default_only_without_the_env(tmp_path):
    code = ("import jax; from margin_tpu.utils import compile_cache as c;"
            "d = c.configure(); print(d);"
            "print(jax.config.jax_compilation_cache_dir)")
    out = _run(["-c", code], {"JAX_PLATFORMS": "cpu",
                              "JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [str(tmp_path)] * 2
    env = {"JAX_PLATFORMS": "cpu"}
    out = _run(["-c", code], dict(env, JAX_COMPILATION_CACHE_DIR=""))
    assert out.returncode == 0, out.stderr
    want = compile_cache.cache_dir("cpu", {})
    assert out.stdout.split() == [want, want]


def test_cli_fails_when_the_backend_fails(sim_phase, tmp_path):
    """A backend that cannot start is an error, not a fall back to the
    CPU (no GPU here, so asking for CUDA must fail)."""
    out = _run(["-m", "margin_tpu", "phase", sim_phase["bam"],
                sim_phase["fasta"], PARAMS, sim_phase["vcf"],
                "-o", str(tmp_path / "out")], {"JAX_PLATFORMS": "cuda"})
    assert out.returncode != 0
    assert not os.path.exists(tmp_path / "out.phased.vcf")


def test_chip_smoke_fails_without_a_gpu():
    out = _run(["chip_smoke.py"], {"JAX_PLATFORMS": "cpu"})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_phase_end_to_end_against_truth(sim_phase, tmp_path):
    from margin_tpu.cli import main
    from margin_tpu.testing import truth

    out = str(tmp_path / "ph")
    main(["phase", sim_phase["bam"], sim_phase["fasta"], PARAMS,
          sim_phase["vcf"], "-o", out, "-t", "2", "-a", "CRITICAL"])
    t = truth.load_truth(sim_phase["truth"])
    tag = truth.haplotag_accuracy(f"{out}.haplotagged.bam",
                                  f"{out}.phaseset.bed", t)
    het = truth.phased_het_stats(f"{out}.phased.vcf", f"{out}.phaseset.bed",
                                 t)
    assert tag["accuracy"] >= 0.95 and tag["tagged"] > 0.9 * tag["reads"]
    assert het["recall"] >= 0.6 and het["genotype_accuracy"] >= 0.95


@pytest.mark.parametrize("diploid", [False, True])
def test_polish_end_to_end_against_truth(sim_polish, tmp_path, diploid):
    from margin_tpu.cli import main
    from margin_tpu.testing import truth

    out = str(tmp_path / "po")
    argv = ["polish", sim_polish["bam"], sim_polish["fasta"], PARAMS,
            "-o", out, "-a", "CRITICAL"]
    main(argv + (["--diploid"] if diploid else []))
    t = truth.load_truth(sim_polish["truth"])
    draft = list(truth.read_fasta(sim_polish["fasta"]).values())[0]
    outs = [f"{out}.hap1.fa", f"{out}.hap2.fa"] if diploid else \
        [f"{out}.fa"]
    draft_best = max(truth.identity(draft, h) for h in t["haplotypes"])
    best = [max(truth.identity(list(truth.read_fasta(fa).values())[0], h)
                for h in t["haplotypes"]) for fa in outs]
    assert sum(best) / len(best) > draft_best, (best, draft_best)
    if not diploid:
        assert best[0] >= 0.99, best
    json.dumps(t["het_sites"])  # truth stays JSON-serializable
