"""The port's own tracing (``lvae_torch/utils/metrics.py``): spans at the
training loop's phase boundaries, phase markers in the captured step, and
the benchmark's readers of both (``perfbench/spans.py``).

With ``torch.profiler`` off a span records nothing and opens no
``record_function``, and the phase helpers do nothing, so eager steps keep
their bits. Under the profiler each span is a host event of its name, its
interval within 100 µs of the recorder's, and a tiny Hensman and a tiny
closed-KL ``fit`` record draws, dispatch, read and callback in that order
under the span that encloses the ``fit``, and so does a tiny GPPVAE
``fit``, whose eager step marks its own five phases in order. The phase
readers give known values on a hand-built window and recorder, and the
three idle shares of the loop plus the idle outside its spans make up the
window's idle share. On the card (marked ``cuda``) a captured Hensman
step's five phase times are positive and sum to within 5% of the replay's
event-timed step, and its replays give the bits of a capture without
markers; the replayed GPPVAE step, markers on, gives the eager step's bits
and its five phases sum to within 15% of the replay's; and its replay
phase launches about as many device kernels at P = 16 as at P = 8.
"""

import collections
import math
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lvae_torch.data.blocks import build_subject_blocks
from lvae_torch.data.datasets import ArrayDataset
from lvae_torch.models.vae import make_vae
from lvae_torch.ops import kernels as kx
from lvae_torch.train import hensman as th
from lvae_torch.train import standard as ts
from lvae_torch.utils import metrics
from perfbench import harness, trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOOP = ("lvae.train.draws", "lvae.train.dispatch", "lvae.train.read", "lvae.train.callback")
P, T, L, M, S = 4, 3, 2, 4, 2
# device kernels of one subject's encoder replay at T 20, L 32
SUBJECT_REPLAY_KERNELS = 150


@pytest.fixture
def recorder(monkeypatch):
    """A fresh recorder in the program's place."""
    rec = metrics.Recorder()
    monkeypatch.setattr(metrics, "RECORDER", rec)
    return rec


def cohort(p=P, t=T):
    rng = np.random.default_rng(0)
    labels = np.asarray([[i, (i - 1.0) * (k % 2), k, k % 2, k % 2, (k // 2) % 2]
                         for k in range(p) for i in range(t)], np.float32)
    return ArrayDataset(data=rng.uniform(size=(p * t, 36, 36, 1)).astype(np.float32),
                        labels=labels,
                        mask=(rng.uniform(size=(p * t, 1296)) > 0.2).astype(np.float32))


def specs():
    return kx.split_kernel_spec(id_covariate=2, cat_kernel=[2], sqexp_kernel=[0],
                                cat_int_kernel=[{"cont_covariate": 0, "cat_covariate": 2}])


def hensman_trainer(device="cpu", p=P, t=T, n_lat=L, m_ind=M, s=S):
    """A ConvVAE Hensman trainer with natural gradients (H + 0.1·I)."""
    ds = cohort(p, t)
    cfg = th.HensmanConfig(*specs(), latent_dim=n_lat, P_tot=p, N_tot=p * t, weight=0.15,
                           loss_function="mse", natural_gradient=True, natural_gradient_lr=0.01,
                           constrain_scales=True, eps=1e-5, dropout=False)
    model = make_vae("conv", n_lat, 1296, dropout=0.0, generator=torch.Generator().manual_seed(1))
    trainer = th.HensmanTrainer(model, cfg, ds, build_subject_blocks(ds.labels, 2),
                                ds.labels[:m_ind], subjects_per_batch=s, seed=0, device=device)
    h = trainer.state.H_nat
    trainer.state = trainer.state._replace(
        H_nat=h + 0.1 * torch.eye(m_ind, device=h.device))
    return trainer


def closed_trainer(device="cpu"):
    ds = cohort()
    cfg = ts.StandardConfig(*specs(), latent_dim=L, P_tot=P, T=T, weight=0.15,
                            loss_function="mse", type_KL="closed", num_samples=1,
                            constrain_scales=True, eps=1e-5, dropout=False)
    model = make_vae("conv", L, 1296, dropout=0.0, generator=torch.Generator().manual_seed(1))
    return ts.StandardTrainer(model, cfg, ds, build_subject_blocks(ds.labels, 2), None,
                              seed=0, device=device)


def gppvae_trainer(device="cpu", p=P, t=T, n_lat=L, m_ind=M):
    """A ConvVAE GPPVAE trainer: the five-phase step over the DUBO."""
    ds = cohort(p, t)
    cfg = ts.StandardConfig(*specs(), latent_dim=n_lat, P_tot=p, T=t, weight=0.15,
                            loss_function="mse", type_KL="GPapprox_closed", num_samples=1,
                            constrain_scales=True, eps=1e-5, dropout=False)
    model = make_vae("conv", n_lat, 1296, dropout=0.0, generator=torch.Generator().manual_seed(1))
    return ts.StandardTrainer(model, cfg, ds, build_subject_blocks(ds.labels, 2),
                              ds.labels[:m_ind], seed=0, pseudo_minibatch=True, device=device)


TRAINERS = {"hensman": hensman_trainer, "closed": closed_trainer, "gppvae": gppvae_trainer}
# the phases each trainer's step marks
STEP_PHASES = {"hensman": metrics.PHASES, "closed": metrics.PHASES,
               "gppvae": metrics.GPPVAE_PHASES}


def arrays(trainer):
    return [p.detach().clone() for p in trainer.state.trainables.parameters()]


# ------------------------------------------------------------------ spans
def test_span_off_records_nothing_and_opens_no_range(recorder, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) opened with tracing off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not metrics.tracing()
    with metrics.span("lvae.train.draws") as s:
        assert s is None
    metrics.phase("vae_forward")
    metrics.phase_end()
    assert not recorder.spans and not recorder.counts and not recorder.samples


def test_each_span_is_a_host_event_of_its_name(recorder):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.autograd.profiler.record_function("warm"):  # the profiler's first range
            pass
        for i in range(5):
            with metrics.span(f"test.outer{i}"):
                with metrics.span("test.inner"):
                    torch.ones(8).sum()
    events = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    inner = sorted(events["test.inner"])
    assert len(recorder.spans) == 10 and recorder.counts["test.inner"] == 5
    for s in recorder.spans:
        (start, end), = ([iv for iv in inner if iv[0] <= s.end_ns and iv[1] >= s.start_ns]
                         if s.name == "test.inner" else events[s.name])
        assert abs(start - s.start_ns) < 100_000 and abs(end - s.end_ns) < 100_000, s
    assert all(s.parent is None for s in recorder.spans if s.name.startswith("test.outer"))
    assert [s.parent for s in recorder.spans if s.name == "test.inner"] == [
        f"test.outer{i}" for i in range(5)]


@pytest.mark.parametrize("kind", sorted(TRAINERS))
def test_fit_records_the_loop_spans_in_order(kind, recorder):
    trainer = TRAINERS[kind]()

    def callback(tr, done, last):
        with metrics.span("test.callback_work"):
            pass

    with profile(activities=[ProfilerActivity.CPU]):
        with metrics.span("test.fit"):
            trainer.fit(2, log_every=0, callback=callback, chunk=1)
    loop = [s for s in recorder.spans if s.name in LOOP]
    assert [s.name for s in loop] == list(LOOP) * 2
    assert all(s.parent == "test.fit" for s in loop)
    (work,) = {s.parent for s in recorder.spans if s.name == "test.callback_work"}
    assert work == "lvae.train.callback"
    ends = [(s.start_ns, s.end_ns) for s in loop]
    assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:]))  # siblings, one after another
    assert not recorder.samples  # the CPU captures nothing: no phase sample


@pytest.mark.parametrize("kind", sorted(TRAINERS))
def test_phase_helpers_keep_eager_steps_bit_equal(kind, recorder):
    """Traced (spans, the eager steps' phase ranges and the multi-grad hook)
    and untraced epochs from one state give the same bits; no marker or
    hook is left behind."""
    plain, traced = TRAINERS[kind](), TRAINERS[kind]()
    plain.fit(2, log_every=0, chunk=1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced.fit(2, log_every=0, chunk=1)
    assert traced.history == plain.history
    for a, b in zip(arrays(traced), arrays(plain)):
        assert torch.equal(a, b)
    assert metrics._markers is None and metrics._eager_phase is None and not metrics._hooks
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert set(STEP_PHASES[kind]) <= names  # each eager phase a range of its name


def test_gppvae_step_marks_its_five_phases_in_order():
    """An eager GPPVAE step under the profiler opens one range a phase, in
    the step's order, one after another."""
    trainer = gppvae_trainer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.run_epoch()
    ranges = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                    for e in prof.profiler.kineto_results.events()
                    if e.name() in metrics.GPPVAE_PHASES)
    assert [n for _, _, n in ranges] == list(metrics.GPPVAE_PHASES)
    assert all(a[1] <= b[0] for a, b in zip(ranges, ranges[1:]))
    assert metrics._eager_phase is None


# ---------------------------------------------------------------- readers
def window(gaps, ops, w0=100.0, w1=101.0):
    busy = sum(e - s for _, s, e in ops)
    return trace.Window(w1 - w0, busy, ops, None, gaps)


def run_of(win, steps=10):
    return harness.Run({}, {}, win, {"steps": steps, "seconds": win.window_s}, 0)


def span(name, a, b, parent=None):
    return metrics.Span(name, parent, int(round(a * 1e9)), int(round(b * 1e9)))


def hand_built(recorder):
    """A 1 s window at t = 100 s: device busy 0.1–0.3, 0.4–0.5, 0.6–0.95;
    draws 0.0–0.2, dispatch 0.2–0.7 (a nested span inside it, which does not
    move the attribution), read 0.7–0.8, callback 0.8–0.85."""
    ops = [("k", 100.1, 100.3), ("k", 100.4, 100.5), ("k", 100.6, 100.95)]
    gaps = [(100.0, 100.1, "x"), (100.3, 100.4, "x"), (100.5, 100.6, "x"),
            (100.95, 101.0, "x")]
    for s in (span("lvae.train.draws", 100.0, 100.2),
              span("lvae.train.dispatch", 100.2, 100.7),
              span("lvae.train.capture", 100.32, 100.38, "lvae.train.dispatch"),
              span("lvae.train.read", 100.7, 100.8),
              span("lvae.train.callback", 100.8, 100.85),
              span("lvae.train.draws", 99.0, 99.5)):  # before the window
        recorder.add(s)
    ms = {"vae_forward": 1.0, "gp_forward": 0.25, "gp_backward": 0.5, "vae_backward": 2.0,
          "update": 0.125, "encode": 0.375, "replay": 4.0}
    for at, scale in ((100.75, 1.0), (100.8, 3.0), (100.85, 2.0), (102.0, 100.0)):
        recorder.samples.append(metrics.PhaseSample("g", int(at * 1e9),
                                                    {k: v * scale for k, v in ms.items()}))
    return run_of(window(gaps, ops))


# (reader, value): draws idles 0.1 of 1 s, dispatch 0.2 (0.3–0.4, 0.5–0.6),
# read and callback none, outside 0.05 (0.95–1.0); the phase sums' medians
# over the three samples in the window (scales 1, 3, 2: the median scale 2)
READINGS = {
    "idle_in_draws.train": 10.0, "idle_in_dispatch.train": 20.0, "idle_in_read.train": 0.0,
    "gp_ms_per_step.train": 1.5, "gp_ms_per_step.full_batch": 1.5,
    "vae_ms_per_step.train": 6.0, "vae_ms_per_step.full_batch": 6.0,
    "update_ms_per_step.train": 0.25, "update_ms_per_step.full_batch": 0.25,
    "encode_ms_per_step.gppvae": 0.75, "replay_ms_per_step.gppvae": 8.0,
}


@pytest.mark.parametrize("name", sorted(READINGS))
def test_reader_on_a_hand_built_window(name, recorder):
    run = hand_built(recorder)
    assert harness.reader(name)(run) == pytest.approx(READINGS[name], abs=1e-9)
    assert harness.reader(name)(run_of(run.window)) is not None
    recorder.clear()
    assert harness.reader(name)(run) is None  # the recorder holds nothing


def test_idle_shares_make_up_the_window_idle_share(recorder):
    from perfbench import spans

    run = hand_built(recorder)
    parts = [harness.reader(f"idle_in_{n}.train")(run) for n in ("draws", "dispatch", "read")]
    outside = 100.0 * spans.idle_by_span(run)[None] / run.window.window_s
    assert outside == pytest.approx(5.0, abs=1e-9)
    assert sum(parts) + outside == pytest.approx(harness.reader("idle_share.train")(run),
                                                 abs=1e-9)


def test_readers_give_none_without_the_recorder(monkeypatch):
    """The parent program has no recorder: every new reader gives None."""
    run = run_of(window([(100.0, 101.0, "x")], []))
    monkeypatch.delattr(metrics, "RECORDER")
    assert all(harness.reader(name)(run) is None for name in READINGS)


# --------------------------------------------------------------- the card
@pytest.mark.cuda
def test_captured_phase_times_sum_to_the_replayed_step(monkeypatch):
    """The five phases of a replayed Hensman step (timed by the events the
    capture recorded) are positive and sum to within 5% of the replay's
    event-timed step; the replays give the bits of a capture without
    markers (cuDNN held to its deterministic algorithms)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    size = dict(p=40, t=20, n_lat=32, m_ind=60, s=20)
    marked, bare = hensman_trainer("cuda", **size), hensman_trainer("cuda", **size)
    order = [[list(range(20)), list(range(20, 40))]]  # bucket 0's two batches
    for _ in range(3):
        marked.run_epoch(order=order)
    (captured,) = marked._graphs.values()
    ms = captured.phase_times()
    assert set(ms) == set(metrics.PHASES) and all(v > 0 for v in ms.values()), ms
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    rows, eps = captured.inputs
    start.record()
    captured.replay(rows, eps)
    end.record()
    end.synchronize()
    ms = captured.phase_times()
    step = start.elapsed_time(end)
    assert math.isclose(sum(ms.values()), step, rel_tol=0.05), (ms, step)

    monkeypatch.setattr(metrics, "capturing", lambda markers: metrics._OFF)
    for _ in range(3):
        bare.run_epoch(order=order)
    (plain,) = bare._graphs.values()
    assert not plain.markers.marks and plain.phase_times() is None
    assert bare.history == marked.history[:3]
    # the marked trainer ran one more replay (the timed one): compare
    # after giving the bare one the same inputs
    plain.replay(rows, eps)
    torch.cuda.synchronize()
    for a, b in zip(arrays(marked), arrays(bare)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_replayed_gppvae_step_is_the_eager_step_and_its_phases_sum_to_it(monkeypatch):
    """At P = 8 (T 20, L 32, M 60) the replays of the captured GPPVAE step,
    its five markers on, give the bits of eager steps (cuDNN held to its
    deterministic algorithms); the five phases of a replay are positive and
    sum to within 15% of its event-timed device time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from lvae_torch.train.graph import eager_steps

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    size = dict(p=8, t=20, n_lat=32, m_ind=60)
    replayed, eager = gppvae_trainer("cuda", **size), gppvae_trainer("cuda", **size)
    replayed.run_epochs(3)
    with eager_steps():
        eager.run_epochs(3)
    torch.cuda.synchronize()
    assert replayed.history == eager.history
    for a, b in zip(arrays(replayed), arrays(eager)):
        assert torch.equal(a, b)
    (captured,) = replayed._graphs.values()
    assert captured.replays == 2 and not eager._graphs
    ms = captured.phase_times()
    assert set(ms) == set(metrics.GPPVAE_PHASES) and all(v > 0 for v in ms.values()), ms
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    captured.replay(*captured.inputs)
    end.record()
    end.synchronize()
    ms = captured.phase_times()
    step = start.elapsed_time(end)
    assert math.isclose(sum(ms.values()), step, rel_tol=0.15), (ms, step)


@pytest.mark.cuda
def test_gppvae_step_kernels_do_not_grow_with_the_cohort(monkeypatch):
    """At P = 8 and P = 16 (T 20, L 32, M 60) the replays of the captured
    GPPVAE step give the bits of eager steps (cuDNN held to its
    deterministic algorithms), and the ``replay`` phase of an eager step,
    traced, launches about as many device kernels at P = 16 as at P = 8:
    one pass over the cohort (``tools/phase_kernel_map.py`` puts each kernel
    to the phase whose range holds its launch; copies and fills are not
    kernels there). A replay a subject launched some 150 kernels at this T
    and L, so 8 more subjects would add ~1200; the counts may differ by the
    kernel or two that cuBLAS and cuDNN pick by shape (147 and 149 on an
    H100), and must differ by less than half of one subject's replay."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from lvae_torch.train.graph import eager_steps

    monkeypatch.syspath_prepend(os.path.join(ROOT, "tools"))
    import phase_kernel_map

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    replay = {}
    for p in (8, 16):
        size = dict(p=p, t=20, n_lat=32, m_ind=60)
        replayed, eager = gppvae_trainer("cuda", **size), gppvae_trainer("cuda", **size)
        replayed.run_epochs(3)
        with eager_steps():
            eager.run_epochs(3)
        torch.cuda.synchronize()
        assert replayed.history == eager.history, p
        for a, b in zip(arrays(replayed), arrays(eager)):
            assert torch.equal(a, b), p
        _, rows = phase_kernel_map.kernel_rows(phase_kernel_map.trace_events(eager))
        replay[p] = collections.Counter()
        for phase, _, name, _, count in rows:
            if phase == "replay":
                replay[p][name] += count
    n8, n16 = sum(replay[8].values()), sum(replay[16].values())
    assert n8 > 0 and abs(n16 - n8) < SUBJECT_REPLAY_KERNELS // 2, (
        n8, n16, replay[8] - replay[16], replay[16] - replay[8])
