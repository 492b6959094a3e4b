"""The card test: one cell run on the chip for 10 seconds (skipped
without a CUDA card)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.card
def test_dlp240_p30_n4_runs_correct(card):
    res = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "dlp240-p30-n4",
         "--seed", str(2**31 + 77), "--seconds", "10", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["attempted"] >= 1 and out["failed"] == 0
    from portbench import spec
    wanted = {m["name"] for m in spec.load("dlp240-p30-n4").end_to_end}
    assert wanted == set(out["metrics"])
    assert out["device"]["platform"] == "gpu"
