"""The benchmark's GPPVAE cell (``hmnist_gppvae.train_epoch``) on the CPU at
a tiny size, in float64: the program's five-phase step with Adam against
the plain full-batch reference (``perfbench/reference/gppvae.py``), which
takes the same gradient by one autograd over the whole cohort; the cell's
readers of the device trace on a hand-built window; the step's operation
count at a size checked by hand; and the imports of the reference and the
count, read from their source, which reach nothing of the program."""

import ast
import math
from pathlib import Path

import pytest
import torch

from perfbench import counts, harness, parts, trace
from perfbench.counts import gppvae as gppvae_counts

ROOT = Path(__file__).resolve().parents[1]
WORKLOAD = "hmnist_gppvae.train_epoch"
SIZE = {"P": 3, "T": 4, "latent_dim": 2, "M": 5}


@pytest.fixture(scope="module")
def traces():
    """(program, reference) traces of the cell's three compared steps."""
    cell = harness.load(WORKLOAD)
    cfg = {**cell.config, **SIZE}
    sut = parts.find("kinds", cell.traffic["kind"]).make(cfg, cell.traffic, 2 ** 31 + 23, "cpu",
                                                         torch.float64)
    sut.setup()
    sut.release()
    return sut.run_trace, sut.reference()


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    gap = float((a - b).norm())
    return gap / float(b.norm()) if gap else 0.0


def test_five_phases_equal_the_full_batch_reference(traces):
    run, ref = traces
    for got, want in ((run.losses, ref.losses), (run.recons, ref.recons)):
        assert len(got) == len(want) == 3
        assert all(math.isclose(a, b, rel_tol=1e-8) for a, b in zip(got, want)), (got, want)
    assert set(run.first_grad) == set(ref.first_grad)
    assert any(float(g.norm()) > 0 for k, g in ref.first_grad.items() if k.startswith("gp."))
    for k, g in ref.first_grad.items():
        assert _rel(run.first_grad[k], g) < 1e-8, k
    assert set(run.change) == set(ref.change)
    for k, c in ref.change.items():
        assert _rel(run.change[k], c) < 1e-8, k


def _window(ops, steps=4, host_calls=None):
    busy = sum(e - s for _, s, e in ops)
    win = trace.Window(1.0, busy, ops, host_calls or {}, [])
    cfg = harness.load(WORKLOAD).config
    return harness.Run(cfg, {}, win, {"steps": steps, "seconds": 1.0,
                                      "flops": steps * gppvae_counts.step_flops(cfg)}, 3 << 30)


OPS = ([("b_chain_warp_kernel", 0.1 * i, 0.1 * i + 0.002) for i in range(4)]
       + [("cudnn_conv_kernel", 0.5, 0.6), ("Memcpy HtoD (Pinned -> Device)", 0.6, 0.61),
          ("Memset (Device)", 0.61, 0.62), ("elementwise_kernel", 0.7, 0.75)])


def test_device_trace_readers_on_a_hand_built_window():
    run = _window(OPS, host_calls={"cudaGraphLaunch": 4, "cudaMemcpyAsync": 6})
    read = {name: harness.reader(name)(run) for name in (
        "kernels_per_step.gppvae", "k1_b_chain_roofline.gppvae", "idle_share.full_batch",
        "host_calls_per_step.full_batch", "peak_mem_gib.full_batch", "mfu.full_batch")}
    assert read["kernels_per_step.gppvae"] == 6 / 4  # copies and fills are not kernels
    bound_s = 1e-3 * counts.b_chain_bound_ms(32, 1000, 20, 6, 3, 2)  # once a step
    assert read["k1_b_chain_roofline.gppvae"] == pytest.approx(100 * 4 * bound_s / 0.008)
    assert read["idle_share.full_batch"] == pytest.approx(100 * (1 - 0.178))
    assert read["host_calls_per_step.full_batch"] == 10 / 4
    assert read["peak_mem_gib.full_batch"] == 3.0
    assert read["mfu.full_batch"] == pytest.approx(100 * 4 * 604.97507712e9 / 67e12)
    # without K1 in the window its share is not read
    assert harness.reader("k1_b_chain_roofline.gppvae")(_window(OPS[4:])) is None


def test_dubo_count_by_hand():
    # L 1, P 1, T 2, M 1: K0zz and W 1 + 1, B's factor and inverse 8/3 + 16/3,
    # B⁻¹K0xz 8, the two M×M sums 4 + 4, the quadratic form 8 + 4 + 2 + 2,
    # the traces 8 + 2 + 2
    assert gppvae_counts.dubo_flops(1, 1, 2, 1) == pytest.approx(54)
    cfg = {"latent_dim": 2, "P": 3, "T": 4, "M": 5, "num_dim": 1296}
    assert gppvae_counts.step_flops(cfg) == pytest.approx(
        counts.vae_flops(2, 36, 12, 0, False) + 3 * counts.vae_flops(2, 36, 4, 4, True)
        + 3 * gppvae_counts.dubo_flops(2, 3, 4, 5))


def _imports(module: str) -> set:
    path = ROOT / (module.replace(".", "/") + ".py")
    if not path.exists():
        path = ROOT / module.replace(".", "/") / "__init__.py"
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names |= {node.module} | {f"{node.module}.{a.name}" for a in node.names}
    return names


@pytest.mark.parametrize("module,reaches", [("perfbench.reference.gppvae",
                                             "perfbench.reference.steps"),
                                            ("perfbench.counts.gppvae", "perfbench.counts")])
def test_reference_and_count_import_nothing_of_the_program(module, reaches):
    """Every module the file imports, and theirs within ``perfbench``, is
    torch, the standard library or the reference's and counts' own."""
    seen, todo = set(), [module]
    while todo:
        mod = todo.pop()
        for name in _imports(mod) - seen:
            seen.add(name)
            top = name.split(".")[0]
            assert top not in ("lvae_torch", "lvae_tpu", "jax", "jaxlib", "flax", "optax"), \
                (mod, name)
            path = ROOT / name.replace(".", "/")
            if top == "perfbench" and (path.with_suffix(".py").exists() or path.is_dir()):
                todo.append(name)
    assert reaches in seen  # the walk followed the benchmark's own modules
