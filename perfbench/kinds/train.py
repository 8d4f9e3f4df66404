"""Training epochs back to back through the trainer's ``fit``, the path the
CLI takes, ``traffic["chunk_epochs"]`` epochs a unit, in the regime that the
configuration names (:mod:`perfbench.regimes`).

Set-up makes the inputs from the seed, builds the trainer on them and runs
``WARM_EPOCHS`` epochs, whose first step captures the step as a CUDA graph
on the card. It then puts the start back into the same tensors (every
trained tensor; the optimizer's moments and step count zeroed, as a fresh
optimizer has them), so that the three compared steps that follow are
replays of that graph, fed as the window feeds them, on the draws of the
next epoch: the capture's own inputs are not among them, so a replay that
leaves its inputs stale trains on the wrong batch. A hook on the trainer's
step keeps the first gradient as Adam holds it (its first moment after one
step, over 1 − β₁) and the state after the third step; the reference
follows those three steps from the same start, on the same draws. One warm
unit ends set-up.
"""

from __future__ import annotations

import gc
import math
from typing import Dict

import torch

from perfbench import parts
from perfbench.inputs import Maker
from perfbench.reference import gp as rg
from perfbench.reference import steps as rs

BETA1 = 0.9


def make(cfg: dict, traffic: dict, seed: int, device="cuda", dtype=torch.float32):
    parts.set_precision(cfg)
    return TrainCell(cfg, traffic, seed, device, dtype)


class TrainCell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device="cuda", dtype=torch.float32):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.dtype = torch.device(device), dtype
        self.regime = parts.find("regimes", cfg["regime"])
        self.attempted = self.failed = 0

    # ------------------------------------------------------------- set-up
    def setup(self) -> None:
        cfg, regime = self.cfg, self.regime
        self.phases = phase = parts.Phases()
        mk = Maker(self.seed, self.device)
        self.data = mk.cohort(cfg, range(cfg["P"]), cfg["pixel_missing"])
        regime.inputs(mk, cfg, self.data)
        state = mk.state(cfg, rg.split_components(cfg))
        self.start = parts.host(state)
        phase("inputs")
        model = parts.model(cfg, state, self.dtype)
        self.trainer = regime.build(cfg, self.data, model, self.seed, self.device, self.dtype)
        self._put(state)
        del state
        phase("trainer")
        self._fit(regime.WARM_EPOCHS)
        self._put(self.start)
        phase("capture")
        self._first_steps()
        phase("first_steps")
        self.unit()  # warm: the chunk's slab sizes and the host copies
        phase("warm_unit")
        self.attempted = self.failed = 0

    def _put(self, state: dict) -> None:
        """``state`` into the trainer's own tensors, in place (a captured
        step reads and writes the tensors it saw), and the optimizer as a
        fresh one starts: every tensor of its state zeroed."""
        with torch.no_grad():
            for k, t in self.regime.trained(self.trainer).items():
                t.copy_(state[k])
            for st in self.trainer.state.opt_state.state.values():
                for v in st.values():
                    if torch.is_tensor(v):
                        v.zero_()

    def _fit(self, epochs: int) -> list:
        """``epochs`` epochs in one ``fit`` chunk, as a unit runs them;
        returns their steps' metrics."""
        regime = self.regime

        def read(trainer, done: int, last) -> None:
            nets = [m.net for m in regime.steps_of(trainer, epochs)]
            self.attempted += len(nets)
            self.failed += sum(not math.isfinite(v) for v in nets)

        self.trainer.fit(epochs, log_every=0, chunk=epochs, callback=read)
        return regime.steps_of(self.trainer, epochs)

    def _first_steps(self) -> None:
        """The three compared steps, with the hook that keeps what the
        comparison needs; on the card each is a replay of the step that
        warming captured."""
        trainer = self.trainer
        real = trainer._run_step
        tensors = self.regime.trained(trainer)
        opt = trainer.state.opt_state
        kept: dict = {}

        def hooked(*args):
            real(*args)
            kept["n"] = kept.get("n", 0) + 1
            if kept["n"] == 1:
                kept["grad"] = {k: (opt.state[p]["exp_avg"] / (1 - BETA1)).detach().cpu()
                                for k, p in tensors.items() if k.startswith(("vae.", "gp."))}
            elif kept["n"] == 3:
                kept["after"] = parts.host(tensors)

        graphs = trainer._graphs
        captured = dict(graphs)
        trainer._run_step = hooked
        try:
            steps = self._fit(self.regime.COMPARED_EPOCHS)[:3]
        finally:
            del trainer._run_step
        if kept.get("n", 0) < 3:
            raise RuntimeError(f"set-up ran {kept.get('n', 0)} steps, the comparison needs 3")
        if self.device.type == "cuda" and (not captured or trainer._graphs is not graphs
                                           or dict(trainer._graphs) != captured):
            raise RuntimeError("the compared steps were not replays of the captured step")
        change = {k: kept["after"][k] - self.start[k] for k in kept["after"]}
        self.run_trace = rs.Trace([float(m.net) for m in steps], [float(m.recon) for m in steps],
                                  kept["grad"], change)

    # ------------------------------------------------------------ traffic
    def unit(self) -> None:
        self._fit(self.traffic["chunk_epochs"])

    def work(self, units: int, seconds: float) -> dict:
        """The work of ``units`` units in ``seconds``: frames trained, steps
        and their operations by the reference's algorithm."""
        epochs = units * self.traffic["chunk_epochs"]
        steps = epochs * self.regime.steps_per_epoch(self.trainer)
        return {"seconds": seconds, "frames": epochs * self.cfg["P"] * self.cfg["T"],
                "steps": steps, "flops": steps * self.regime.step_flops(self.cfg)}

    # --------------------------------------------------------- the check
    def release(self) -> None:
        del self.trainer
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, tf32: bool = False, half_batch: bool = False) -> rs.Trace:
        return self.regime.reference(self.cfg, self.data, self.start, self.seed, tf32=tf32,
                                     half_batch=half_batch, device=self.device, dtype=self.dtype,
                                     skip_epochs=self.regime.WARM_EPOCHS)

    def gaps(self) -> Dict[str, float]:
        return {f"{k}_gap": v for k, v in rs.train_gaps(self.run_trace, self.reference()).items()}
