"""chip_smoke.py at tiny sizes on the CPU: each one-card phase, the
four-device phases on 4 virtual devices, the exit without a GPU, and the
compile-cache placement.  The full-size run needs the card (README)."""

import dataclasses
import os
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke as cs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny(ph: cs.Phase) -> cs.Phase:
    return dataclasses.replace(
        ph, n=8_000 if ph.amino else 20_000, nq=512, k=3 if ph.amino else 6
    )


@pytest.mark.parametrize("phase", cs.PHASES, ids=[p.name for p in cs.PHASES])
def test_phase_tiny(phase, tmp_path):
    lines = []
    summary = cs.run_phase(_tiny(phase), 0, str(tmp_path), log=lines.append, sample_frac=0.05)
    assert summary["queries"] == 512 * (phase.drawn_batches + 1)
    text = "\n".join(lines)
    assert "checks passed" in text and "parallel_locate agree" in text
    assert "native SA-IS" in text
    assert ("round trip" in text) == phase.awry_round_trip


@pytest.fixture(scope="module")
def four_ctx(tmp_path_factory):
    return cs.four_setup(
        0, str(tmp_path_factory.mktemp("four")), jax.devices()[:4], log=lambda _: None,
        n=40_000, nq=1024, workers=1, sample_frac=0.05,
    )


@pytest.mark.parametrize("run", [cs.four_mode_a, cs.four_mode_b, cs.four_federation],
                         ids=["mode_a", "mode_b", "federation"])
def test_four_phases_on_virtual_devices(four_ctx, run):
    lines = []
    run(four_ctx, log=lines.append)
    assert any("identical to the one-card engine" in line for line in lines)
    assert len(four_ctx.devices) == 4


def _run_script(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True, text=True, timeout=300
    )


def test_exits_nonzero_without_gpu():
    r = _run_script(ROOT, "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and "no GPU" in r.stderr


def test_exits_nonzero_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run_script(str(tmp_path), "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("env,expected", [
    ({}, os.path.join(ROOT, ".jax_cache")),
    ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere/cache"}, "/elsewhere/cache"),
], ids=["unset", "set"])
def test_compile_cache_dir(env, expected):
    assert cs.compile_cache_dir(env) == expected


@pytest.mark.gpu
def test_phases_on_gpu(gpu, tmp_path):
    """Every one-card phase at a tiny size on the card, in a child process
    (this one is pinned to the CPU)."""
    code = (
        "import dataclasses, sys; sys.path.insert(0, sys.argv[1]); import chip_smoke as cs\n"
        "import jax; assert jax.devices()[0].platform == 'gpu'\n"
        "for p in cs.PHASES:\n"
        "    cs.run_phase(dataclasses.replace(p, n=200_000, nq=4096), 0, sys.argv[2])\n"
    )
    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    r = subprocess.run([sys.executable, "-c", code, ROOT, str(tmp_path)], env=env,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
