"""One short run of each cell on the card, as the benchmark's command runs
it: exit 0 and a well-formed last line. Skips without a card."""
import json
import subprocess
import sys

import pytest
import torch

from benchmark.harness import manifest

MAN = manifest.manifest()


@pytest.mark.cuda
@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_a_short_run_of_each_cell(w):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", w["name"],
         "--seed", "2147483659", "--seconds", "5", "--trace", "0"],
        cwd=manifest.ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["device"]["platform"] == "gpu"
    assert "setup_s" in res["metrics"]
