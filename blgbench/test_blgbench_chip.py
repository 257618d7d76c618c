"""Every cell on the card, as the driver runs it, for a short window:
sound it is correct; with the control planted it is not. Marked `cuda`:
`python -m pytest -q -p no:cacheprovider -m cuda blgbench` (~4 min on
one H100, most of it the bundle's quality-11 encode)."""
import json
import subprocess
import sys

import pytest

from blgbench import harness

CELLS = [c["name"] for c in harness.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [None, "lossy"])
def test_cell_on_the_card(cell, fault):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cmd = [sys.executable, "blgbench/run.py", "--workload", cell,
           "--seed", "4000000001", "--seconds", "2", "--trace", "0"]
    if fault:
        cmd += ["--fault", fault]
    out = subprocess.run(cmd, cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is (fault is None), result["checks"]
    assert result["device"]["platform"] == "gpu"
    if fault is None:
        assert set(result["metrics"]) == {
            m["name"] for m in harness.cell_metrics(
                harness.benchmark(), cell, "end_to_end")}
