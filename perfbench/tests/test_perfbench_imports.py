"""No run loads JAX or the JAX package, the reference loads nothing of the
program, and nothing under ``perfbench/`` reads the JAX package's benchmarks.

Each check runs in a fresh interpreter and compares the top-level name of
every loaded module (the part before the first dot) whole: the port's name
begins with the JAX package's."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "lvae_tpu"}


def _loaded_tops(code: str) -> set:
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH",)}
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_every_file_it_finds_load_no_jax():
    code = f"""
import sys, json, runpy
sys.path.insert(0, {str(ROOT)!r})
runpy.run_path({str(BENCH / 'run.py')!r}, run_name='perfbench_run')
from perfbench import harness, parts, control
bench = json.load(open({str(ROOT / 'BENCHMARK.json')!r}))
for w in bench['workloads']:
    cell = harness.load(w['name'])
    parts.find('kinds', cell.traffic['kind'])
    parts.find('regimes', cell.config['regime'])
for m in bench['end_to_end'] + bench['per_layer']:
    harness.reader(m['name'])
import lvae_torch.train.hensman, lvae_torch.train.standard, lvae_torch.train.graph
"""
    tops = _loaded_tops(code)
    assert "lvae_torch" in tops
    assert not tops & FORBIDDEN, sorted(tops & FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
import perfbench.reference.model, perfbench.reference.gp, perfbench.reference.steps
import perfbench.counts, perfbench.inputs
"""
    tops = _loaded_tops(code)
    assert not tops & (FORBIDDEN | {"lvae_torch"}), sorted(tops & (FORBIDDEN | {"lvae_torch"}))


@pytest.mark.parametrize("kind", ["configs", "traffic", "limits"])
def test_every_data_file_is_json(kind):
    files = sorted((BENCH / kind).glob("*"))
    assert files
    for f in files:
        assert f.suffix == ".json"
        json.loads(f.read_text())


def test_nothing_reads_the_jax_benchmarks():
    for f in BENCH.rglob("*.py"):
        if f.name == Path(__file__).name:
            continue
        text = f.read_text()
        assert "benchmarks/" not in text and "benchmarks." not in text, f
