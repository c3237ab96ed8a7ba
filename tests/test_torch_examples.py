"""The port's five examples (``examples/torch/``) run on the CPU.

Each runs as its user would run it, in a process of its own with
``--device cpu``, in the test's ``tmp_path`` (where anything it writes
lands) and under a time limit of its own.  Each mirrors its reference in
``examples/`` at the reference's sizes; ``train_lm`` takes 8 of its 200
default steps.  Each must exit 0 and end in ``OK``; on the CPU every
kernel call takes its plain version, so no kernel launch is counted.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples" / "torch"
TIMEOUT_S = 300

CASES = {
    "quickstart": [],
    "ring_simulation": [],
    "serve_lm": [],
    "train_lm": ["--steps", "8", "--out", "run"],
    "verify_env": [],
}


def test_every_reference_example_has_a_port():
    assert sorted(p.stem for p in (REPO / "examples").glob("*.py")) == sorted(
        CASES)
    assert sorted(p.stem for p in EXAMPLES.glob("*.py")) == sorted(CASES)


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_runs_on_the_cpu(name, tmp_path):
    # one intra-op thread a process: the suite's other workers share the
    # cores
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "OMP_NUM_THREADS": "1"}
    r = subprocess.run([sys.executable, str(EXAMPLES / f"{name}.py"),
                        "--device", "cpu", *CASES[name]],
                       capture_output=True, text=True, cwd=tmp_path,
                       env=env, timeout=TIMEOUT_S)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert lines[-1].startswith("OK"), lines[-3:]
    launches = json.loads(next(line for line in lines
                               if line.startswith("LAUNCHES "))[9:])
    assert launches and not any(launches.values()), launches
    if name == "train_lm":
        manifest = json.loads((tmp_path / "run" / "manifest.json").read_text())
        assert manifest["binding"]["device_kind"] == "cpu"
        assert manifest["attestation"]["program_fingerprint"]
