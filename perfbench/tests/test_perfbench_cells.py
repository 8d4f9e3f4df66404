"""Each cell once on the card for a short window, untraced and traced: the
last line keeps to the benchmark's contract and the traced run gives every
per-layer metric of the cell. Marked ``cuda``; skips without a card."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _metrics_of(workload: str, traced: bool) -> set:
    if traced:
        return {m["name"] for m in BENCH["per_layer"] if workload in m["workloads"]}
    return {m["name"] for m in BENCH["end_to_end"] if workload in m.get("workloads", [workload])}


@pytest.mark.cuda
@pytest.mark.parametrize("traced", [0, 1])
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_line(card, workload, traced):
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", workload, "--seed",
                          str(2 ** 31 + 101), "--seconds", "2", "--trace", str(traced)],
                         cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == _metrics_of(workload, bool(traced))
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1 and dev["memory_peak_bytes"] > 0
    if traced:
        assert 0 < dev["busy_s"] <= dev["window_s"]
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        for name, value in line["metrics"].items():
            if "roofline" in name or "mfu" in name:
                assert 0 < value["value"] <= 100, (name, value)
    err = out.stderr.strip().splitlines()
    assert err[-len(line["checks"]):] == [f"check {k} {c['value']!r} limit {c['limit']!r}"
                                          for k, c in line["checks"].items()]


def test_without_a_card_it_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
