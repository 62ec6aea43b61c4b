"""Test harness configuration.

Tests run on the CPU backend with 8 virtual devices so multi-device
sharding paths (mesh + shard_map) are exercised without a GPU, per the
framework's test strategy (SURVEY.md section 4: simulate several devices
with xla_force_host_platform_device_count before touching real cards).
Must be set before jax is imported anywhere.  Tests that need a card carry
the ``gpu`` marker and skip here (see the ``gpu`` fixture).
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

# Authoritative even if an accelerator plugin is installed.
jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest

from awry_tpu.alphabet import Alphabet


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def random_dna(rng, n: int) -> bytes:
    return bytes(rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=n))


def random_amino(rng, n: int) -> bytes:
    return bytes(rng.choice(np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype=np.uint8), size=n))


def random_seq(alphabet: Alphabet, rng, n: int) -> bytes:
    return random_dna(rng, n) if alphabet is Alphabet.NUCLEOTIDE else random_amino(rng, n)


@pytest.fixture
def gpu():
    """Skips unless an NVIDIA card is present (decided at run time, never at
    import: every xdist worker must collect the same tests)."""
    import shutil
    import subprocess

    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run([smi, "-L"], capture_output=True).returncode != 0:
        pytest.skip("needs an NVIDIA GPU: run on the card with `python -m pytest -m gpu tests/`")


# Fast inner-loop subset (round-2 verdict task 10): `pytest -m smoke` runs in
# well under a minute, so every milestone can afford a pre-commit run.  The
# heavy modules (fuzz, spawned multi-process, partition federation) stay
# full-suite-only.
_SMOKE_MODULES = {
    "test_alphabet",
    "test_fm_index_api",
    "test_suffix_array",
    "test_io_formats",
    "test_kmer_device",
    "test_host_engine",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.module.__name__.rsplit(".", 1)[-1] in _SMOKE_MODULES:
            item.add_marker(pytest.mark.smoke)
