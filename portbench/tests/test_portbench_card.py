"""The one test that needs the card: a short run of the first cell
through the benchmark's own command, `correct` true."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.mark.card
def test_first_cell_runs_correct_on_the_card(cuda_card):
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "emseq_wgs_duplex.dup4", "--seed",
         "2147483659", "--seconds", "5", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
