"""CLI surface: build/count/locate/info subcommands."""

import json
import subprocess
import sys

import numpy as np

from .conftest import random_seq
from awry_tpu.alphabet import Alphabet


def _run(args, **kw):
    import os

    env = dict(os.environ)
    # Keep CLI subprocesses on the CPU backend: the --host paths are pure
    # NumPy, and the device paths are tested in-process.
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, "-m", "awry_tpu", *args],
        capture_output=True, text=True, env=env, **kw,
    )


def test_cli_round_trip(rng, tmp_path):
    seq = random_seq(Alphabet.NUCLEOTIDE, rng, 300)
    fasta = tmp_path / "g.fasta"
    fasta.write_bytes(b">rec\n" + seq + b"\n")
    idx = str(tmp_path / "g.npz")

    r = _run(["build", str(fasta), "-o", idx, "--kmer-len", "3"])
    assert r.returncode == 0, r.stderr
    assert "built" in r.stderr

    q = seq[10:30].decode()
    r = _run(["count", idx, q, "ZZZZZZZZ", "--host"])
    assert r.returncode == 0, r.stderr
    lines = dict(l.split("\t") for l in r.stdout.strip().splitlines())
    assert lines[q] >= "1" and lines["ZZZZZZZZ"] == "0"

    r = _run(["locate", idx, q, "--host"])
    assert r.returncode == 0, r.stderr
    assert "rec" in r.stdout

    # Non-host path (device engine on the CPU backend) must agree.
    r2 = _run(["locate", idx, q])
    assert r2.returncode == 0, r2.stderr
    assert sorted(r2.stdout.splitlines()) == sorted(r.stdout.splitlines())

    r = _run(["info", idx])
    meta = json.loads(r.stdout)
    assert meta["bwt_len"] == 301 and meta["records"] == 1

    # --awry with a conflicting -o extension is an error, not silence.
    r = _run(["build", str(fasta), "--awry", "-o", str(tmp_path / "x.idx")])
    assert r.returncode == 2 and "--awry requires" in r.stderr


def test_cli_host_flag_stays_off_device(rng, tmp_path):
    """--host must never construct the device engine (the flag exists to
    keep CLI runs off exclusive/slow device runtimes)."""
    seq = random_seq(Alphabet.NUCLEOTIDE, rng, 120)
    fasta = tmp_path / "g.fasta"
    fasta.write_bytes(b">r\n" + seq + b"\n")
    idx = str(tmp_path / "g.npz")
    assert _run(["build", str(fasta), "-o", idx, "--kmer-len", "2"]).returncode == 0
    probe = (
        "import sys, awry_tpu.ops.engine as E\n"
        "def boom(*a, **k): raise SystemExit('device engine constructed under --host')\n"
        "E.FmQueryEngine.__init__ = boom\n"
        f"from awry_tpu.__main__ import main\n"
        f"sys.exit(main(['count', {idx!r}, 'ACG', '--host']))\n"
    )
    import os
    import subprocess
    import sys as _sys

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([_sys.executable, "-c", probe], capture_output=True, text=True, env=env)
    assert r.returncode == 0, r.stderr
    assert "device engine constructed" not in r.stderr
