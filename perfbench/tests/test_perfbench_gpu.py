"""On the card: one short run of a cell through the command line, held to
the contract's last line (skips without a card)."""
import json
import subprocess
import sys

import pytest

from perfbench import harness


@pytest.mark.gpu
def test_a_short_run_on_the_card_is_correct(cuda):
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "lenet5-dfl.sweep24x10",
         "--seed", str(2 ** 31 + 77), "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert line["metrics"]["sweep_ticks_per_s"]["value"] > 0
