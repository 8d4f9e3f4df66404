"""The port's sharded Hensman training and sharded serving
(lvae_torch/parallel/) on the CPU, over gloo ranks, against one process
of the port and against lvae_tpu's mesh trainer and predictor.

Each mesh shape is one world of spawned ranks (``tests/torch_parallel_worker.py``)
that runs every check of that shape and returns its arrays; the worlds run
while this process computes the references. The problem is the JAX
sharding tests' tiny cohort (P=8 subjects x T=4 frames, L=4, M=6, 4
subjects a batch, SimpleVAE, float64), from one state that lvae_tpu makes
and ``utils/convert`` carries over, with the batch order and the noise
injected on both sides. Tolerances: net and KL within 1e-8 relative of
both references, the final (m, H) within 1e-6 relative and 1e-9 absolute,
as ``tests/test_sharding.py`` holds lvae_tpu's mesh trainer; the posterior
within 1e-8.

The f32 case runs one step from a state whose latents differ in scale by
two orders of magnitude (so the adaptive jitter's mean over one latent
shard is far from its mean over all L) and whose last latent's
natural-gradient step leaves the PSD cone: the losses must equal one
process's at 1e-3 relative (the KL is 1.8e4, summed in f32 in another order
from terms near 1e7: measured 1.4e-4; a jitter mean taken per latent shard
moves them by 2.9e2, and a guard taken per shard keeps the first shard's
step, measured by breaking each in a copy), and every rank must refuse the
step, as one process does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lvae_tpu.data.blocks import build_subject_blocks
from lvae_tpu.models import vae as jv
from lvae_tpu.ops import elbo as jeb
from lvae_tpu.ops import kernels as jkx
from lvae_tpu.ops import linalg as jla
from lvae_tpu.ops.predict import build_predict_inputs as jbuild_inputs
from lvae_tpu.ops.predict import gp_predict as jgp_predict
from lvae_tpu.parallel import mesh as jpm
from lvae_tpu.train import hensman as jth
from lvae_tpu.train import state as jst
from lvae_torch.ops import kernels as tkx
from lvae_torch.parallel import distributed as tpd
from lvae_torch.parallel import mesh as tpm
from lvae_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from lvae_torch.utils.convert import hensman_state_from_jax
from tests import torch_parallel_worker as w
from tests.test_training import make_cfg, tiny_cohort

SHAPES = [(2, 1), (1, 2), (2, 2)]
EPOCHS = 3
F32_LR = 2.0  # with H_3 = 1e-6·I the last latent's step leaves the cone


def jax_trainer():
    """lvae_tpu's trainer of the JAX sharding tests, its state in float64."""
    ds = tiny_cohort(p=w.P, t=w.T, seed=0)
    cfg = make_cfg(True, p=w.P, t=w.T, latent_dim=w.L)
    model = jv.SimpleVAE(latent_dim=w.L, num_dim=20, dtype=jnp.float64)
    z = jst.init_inducing_points(ds.labels, w.M, seed=0, dtype=np.float64)
    jtr = jth.HensmanTrainer(model, cfg, ds, build_subject_blocks(ds.labels, id_covariate=2), z,
                             subjects_per_batch=w.S, seed=0, dtype=jnp.float64)
    tr64 = jax.tree.map(lambda x: x.astype(jnp.float64), jtr.state.trainables)
    jtr.state = jtr.state._replace(trainables=tr64, opt_state=jtr.optimizer.init(tr64))
    return jtr


def jax_run(shape, orders, eps, holder):
    """lvae_tpu's ShardedHensmanTrainer at ``shape`` (8 virtual CPU devices)
    on the injected batches: per-epoch mean metrics and the final (m, H)."""
    jtr = jax_trainer()
    mesh = jpm.make_mesh(*shape)
    jpm.ShardedHensmanTrainer(jtr, mesh)
    table = jtr.tables[0]

    def step(state, rows, e):
        holder["eps"] = e
        idx = jnp.take(table.index, rows, axis=0)
        bmask = jnp.take(table.mask, rows, axis=0)
        p_batch = jnp.sum(rows < table.num_real).astype(bmask.dtype)
        (_, (metrics, ng)), grads = jax.value_and_grad(
            lambda tr: jth.batch_loss(jtr.model, jtr.cfg, tr, state.m_nat, state.H_nat,
                                      jtr.tdata, idx, bmask, p_batch, jax.random.key(0),
                                      mesh=mesh),
            has_aux=True)(state.trainables)
        updates, opt_state = jtr.optimizer.update(grads, state.opt_state, state.trainables)
        m_nat, h_nat = jeb.natural_gradient_update(state.m_nat, state.H_nat, ng,
                                                   jtr.cfg.natural_gradient_lr)
        return state._replace(trainables=optax.apply_updates(state.trainables, updates),
                              opt_state=opt_state, m_nat=m_nat, H_nat=h_nat), metrics

    step = jax.jit(step)
    state, epochs = jtr.state, []
    with mesh, jla.pallas_suppressed(True):
        for order, noise in zip(orders, eps):
            ms = []
            for rows, e in zip(order, noise):
                state, metrics = step(state, jnp.asarray(rows), jnp.asarray(e))
                ms.append([float(v) for v in metrics])
            epochs.append(np.mean(ms, axis=0))
    return {"epochs": np.asarray(epochs), "m": np.asarray(state.m_nat),
            "H": np.asarray(state.H_nat)}


def jax_predict(problem, shape):
    spec0_t, spec1_t, kp0, kp1, noise, train, test, mu, z = problem
    spec0, spec1 = jkx.split_kernel_spec(id_covariate=2, **w.SPEC)
    jkp0 = jkx.KernelParams(raw_scale=jnp.asarray(kp0[0]), raw_lengthscale=jnp.asarray(kp0[1]))
    jkp1 = jkx.KernelParams(raw_scale=jnp.asarray(kp1[0]), raw_lengthscale=jnp.asarray(kp1[1]))
    inputs, _, _ = jbuild_inputs(train.labels, mu, test.labels, id_covariate=2, dtype=np.float64)
    single = np.asarray(jgp_predict(spec0, spec1, jkp0, jkp1, jnp.asarray(noise), inputs,
                                    jnp.asarray(z), 1e-6))
    sharded = np.asarray(jpm.sharded_gp_predict(spec0, spec1, jkp0, jkp1, jnp.asarray(noise),
                                                inputs, jnp.asarray(z), jpm.make_mesh(*shape),
                                                eps=1e-6))
    return single, sharded


def f32_state(path):
    """An f32 checkpoint whose latents differ in kernel scale and whose last
    latent's H is 1e-6·I (the others 100·I)."""
    trainer = w.hensman_trainer(dtype=torch.float32)
    with torch.no_grad():
        trainer.state.trainables.gp.kp0.raw_scale.copy_(
            torch.tensor([[-3.0], [-3.0], [4.0], [4.0]]))
        h = torch.eye(w.M).expand(w.L, w.M, w.M) * torch.tensor([100.0, 100.0, 100.0, 1e-6])[
            :, None, None]
    trainer.state = trainer.state._replace(H_nat=h.clone())
    save_checkpoint(path, trainer.state)
    return trainer


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel")
    jtr = jax_trainer()
    port = w.hensman_trainer()
    port.state = hensman_state_from_jax(jtr.state, port.model, dtype=torch.float64)
    ckpt = str(root / "start.ckpt")
    save_checkpoint(ckpt, port.state)
    f32_ckpt = str(root / "f32.ckpt")
    f32_state(f32_ckpt)

    rng = np.random.default_rng(1)
    orders = [rng.permutation(w.P).reshape(-1, w.S) for _ in range(EPOCHS)]
    eps = rng.normal(size=(EPOCHS, w.P // w.S, w.S * w.T, w.L))
    f32_rows = np.arange(w.S)
    f32_eps = rng.normal(size=(w.S * w.T, w.L)).astype(np.float32)
    saved = str(root / "saved_by_2.ckpt")
    # 3 subjects a batch (the table's 9th row a ghost): each batch is padded
    # with one more ghost to the 2-way data axis
    odd_orders = [np.append(rng.permutation(w.P), w.P).reshape(3, 3) for _ in range(2)]
    odd_eps = rng.normal(size=(2, 3, 3 * w.T, w.L))

    ctxs = {}
    for shape in SHAPES:
        extra = {"predict": True}
        if shape == (1, 2):
            extra["f32"] = dict(ckpt=f32_ckpt, rows=f32_rows, eps=f32_eps, lr=F32_LR)
        if shape == (2, 1):
            extra["save_to"] = saved
            extra["odd_batch"] = (odd_orders, odd_eps)
        out = str(root / f"w{shape[0]}{shape[1]}")
        ctxs[shape] = (w.launch(shape[0] * shape[1], "world_hensman",
                                (shape, ckpt, orders, eps, extra), out), out)

    # the references, while the worlds run
    mp = pytest.MonkeyPatch()
    holder = {}
    mp.setattr(jv, "sample_latent",
               lambda rng, mu, log_var: mu + holder["eps"] * jnp.exp(0.5 * log_var))
    try:
        refs = {"port": w.hensman_steps(port, orders, eps),
                "jax": {shape: jax_run(shape, orders, eps, holder) for shape in SHAPES}}
    finally:
        mp.undo()
    problem = w.predict_problem()
    refs["predict"] = w.torch_predict(problem)
    refs["predict_flat"] = w.torch_predict(problem, flat=True)
    refs["predict_unaligned"] = w.torch_predict(w.predict_problem(p_query=3))
    refs["jax_predict"] = {shape: jax_predict(problem, shape) for shape in SHAPES}
    refs["f32"] = w.f32_step(f32_ckpt, f32_rows, f32_eps, F32_LR)
    refs["saved"] = saved
    odd = w.hensman_trainer(subjects_per_batch=3)
    odd.state = load_checkpoint(ckpt, like=odd.state)
    refs["odd_batch"] = w.hensman_steps(odd, odd_orders, odd_eps)
    refs["resume"] = (port, orders, eps)
    results = {shape: w.collect(ctx, out) for shape, (ctx, out) in ctxs.items()}
    return results, refs


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b) / np.abs(b)))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_hensman_matches_one_process(worlds, shape):
    results, refs = worlds
    ref = refs["port"]
    for rank, out in enumerate(results[shape]):
        got = out["hensman"]
        # net and kld (columns 0 and 3) of every epoch, on every rank
        np.testing.assert_allclose(got["epochs"][:, [0, 3]], ref["epochs"][:, [0, 3]],
                                   rtol=1e-8, err_msg=f"rank {rank}")
        np.testing.assert_allclose(got["epochs"], ref["epochs"], rtol=1e-8)
        np.testing.assert_allclose(got["m"], ref["m"], rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(got["H"], ref["H"], rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_hensman_matches_jax_mesh_trainer(worlds, shape):
    results, refs = worlds
    ref = refs["jax"][shape]
    for out in results[shape]:
        got = out["hensman"]
        np.testing.assert_allclose(got["epochs"][:, [0, 3]], ref["epochs"][:, [0, 3]], rtol=1e-8)
        np.testing.assert_allclose(got["m"], ref["m"], rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(got["H"], ref["H"], rtol=1e-6, atol=1e-9)


def test_batch_that_does_not_divide_the_data_axis_is_padded_with_a_ghost(worlds):
    """3 subjects a batch on a 2-way data axis: each rank takes 2 rows of
    the batch padded to 4, and the numbers are one process's."""
    results, refs = worlds
    ref = refs["odd_batch"]
    for out in results[(2, 1)]:
        got = out["odd_batch"]
        np.testing.assert_allclose(got["epochs"], ref["epochs"], rtol=1e-8)
        np.testing.assert_allclose(got["H"], ref["H"], rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_rank_shards_have_the_latent_slices(worlds, shape):
    """shard_hensman_state keeps a rank's latent slice of the [L, ...]
    leaves when L divides the latent axis."""
    results, _ = worlds
    want = w.L // shape[1]
    for out in results[shape]:
        assert out["shard_shapes"] == {"H_nat": (want, w.M, w.M), "raw_scale": (want, 1)}


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_gp_predict_matches(worlds, shape):
    """sharded_gp_predict and predict_latents(mesh=) against one process of
    the port and lvae_tpu's sharded_gp_predict, on every rank."""
    results, refs = worlds
    jax_single, jax_sharded = refs["jax_predict"][shape]
    np.testing.assert_allclose(refs["predict"], jax_single, rtol=1e-8, atol=1e-12)
    for out in results[shape]:
        np.testing.assert_allclose(out["predict"], refs["predict"], rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(out["predict"], jax_sharded, rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(out["predict_flat"], refs["predict_flat"], rtol=1e-8,
                                   atol=1e-12)


def test_unaligned_query_axis_is_replicated_with_a_warning(worlds):
    """3 query subjects on a 2-way data axis: replicated, the same numbers,
    and a warning that names the axis."""
    results, refs = worlds
    for out in results[(2, 1)]:
        np.testing.assert_allclose(out["predict_unaligned"], refs["predict_unaligned"],
                                   rtol=1e-8, atol=1e-12)
        assert any("does not divide the 2-way 'data' mesh axis" in m for m in out["warnings"])
    # aligned everywhere at (1, 2) and (2, 2): no replication warning there
    # but the unaligned queries' own
    for out in results[(2, 2)]:
        assert [m for m in out["warnings"] if "(queries)" not in m] == []


def test_f32_guard_and_jitter_act_on_the_whole_latent_axis(worlds):
    """At (1, 2) the f32 losses read the adaptive jitter's mean over all L,
    and the last latent's refusal holds on both ranks."""
    results, refs = worlds
    ref = refs["f32"]
    assert not ref["kept"], "one process must refuse this step"
    # the test is sensitive: a mean over one latent shard moves the jitter
    # far from the mean over all L
    trainer = w.hensman_trainer(dtype=torch.float32)
    kp0 = tkx.KernelParams(torch.tensor([[-3.0], [-3.0], [4.0], [4.0]]),
                           trainer.state.trainables.gp.kp0.raw_lengthscale.detach())
    kzz = tkx.kernel_matrix(trainer.cfg.spec0, kp0, trainer.tdata.z, trainer.tdata.z)
    diag = torch.diagonal(kzz, dim1=-2, dim2=-1)
    assert diag[2:].mean() > 100 * diag[:2].mean()
    for out in results[(1, 2)]:
        got = out["f32"]
        np.testing.assert_allclose(got["metrics"], ref["metrics"], rtol=1e-3)
        assert not got["kept"], "a rank kept a step another rank refused"
        np.testing.assert_array_equal(got["m"], ref["m"])


def test_checkpoint_saved_by_two_ranks_resumes_in_one_process(worlds):
    """A (2, 1) run's checkpoint holds the whole state: one process loads
    it, and it equals one process's own state after the same steps; one
    more epoch from each agrees."""
    _, refs = worlds
    port, orders, eps = refs["resume"]
    loaded = w.hensman_trainer()
    loaded.state = load_checkpoint(refs["saved"], like=loaded.state)
    np.testing.assert_allclose(loaded.state.H_nat.numpy(), port.state.H_nat.numpy(),
                               rtol=1e-6, atol=1e-9)
    for a, b in zip(loaded.state.trainables.parameters(), port.state.trainables.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-6,
                                   atol=1e-9)
    assert loaded.state.step == port.state.step == EPOCHS * (w.P // w.S)
    more_a = w.hensman_steps(loaded, orders[:1], eps[:1])
    more_b = w.hensman_steps(port, orders[:1], eps[:1])
    np.testing.assert_allclose(more_a["epochs"], more_b["epochs"], rtol=1e-6)


def test_make_mesh_refuses_another_world_size():
    with pytest.raises(ValueError, match="needs 2 processes; the world size is 1"):
        tpm.make_mesh(2, 1, device="cpu")
    with pytest.raises(ValueError, match="needs 4 processes"):
        tpm.make_mesh(2, 2, device="cpu")
    trivial = tpm.make_mesh(1, 1, device="cpu")
    assert trivial.world_group is None and trivial.size == 1 and trivial.writer
    view = trivial.view(8, 4)
    x = torch.arange(4.0, requires_grad=True)
    assert view.data_sums(x)[0] is x and view.gather_latents(x, 4) is x  # no collective
    assert view.weight("data") == view.weight("latent") == 1.0


def test_initialize_distributed_is_a_no_op_in_one_process(monkeypatch):
    for name in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    assert tpd.initialize_distributed(device="cpu") == 1
    assert not torch.distributed.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        tpd.initialize_distributed(device="cpu")
    assert tpd.make_global_mesh(device="cpu").shape == {"data": 1, "latent": 1}
    assert tpd.choose_backend(torch.device("cpu"), 2) == "gloo"
