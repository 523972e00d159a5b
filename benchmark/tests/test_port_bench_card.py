"""One short run of each cell on the card, through the command the
benchmark's checks run (``python -m pytest benchmark/tests -m card`` on a
machine with a CUDA device; skipped elsewhere)."""

import json
import subprocess
import sys

import pytest

from benchmark import spec


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      spec.load_benchmark()["workloads"]])
def test_a_short_run_is_correct(card, workload):
    bench = spec.load_benchmark()
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", workload,
         "--seed", str(2 ** 31 + 3), "--seconds", "3", "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["check"]
    assert set(res["metrics"]) == {m["name"] for m in spec.cell_metrics(
        bench, workload, False)}
    assert res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "check"
