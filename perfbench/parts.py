"""What every kind of cell builds the program from: the precision the
configuration states, the kernel spec and the VAE through the program's
public constructors, the cohort in the form its trainers take, and the
host clock of each set-up phase."""

from __future__ import annotations

import importlib
import time
from types import ModuleType
from typing import List

import torch


def find(package: str, name: str) -> ModuleType:
    """The module ``perfbench/<package>/<name>.py``: a kind of traffic or a
    training regime, found by the name a mix or a configuration gives."""
    if not name.isidentifier():
        raise ValueError(f"{package} name {name!r} is not a module name")
    return importlib.import_module(f"perfbench.{package}.{name}")


def set_precision(cfg: dict) -> None:
    """The configurations state float32 with TF32 off: the program holds its
    forward passes and GP algebra to that itself, but leaves the
    convolutions' backward to torch's process-wide cuDNN switch, which is on
    by default; it is switched off here, as the configuration states (the
    program's captured steps are keyed on it)."""
    if cfg["precision"].startswith("float32, TF32 off"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def kernel_spec(cfg: dict):
    from lvae_torch.ops import kernels as kx

    return kx.split_kernel_spec(
        cat_kernel=cfg["cat_kernel"], bin_kernel=cfg["bin_kernel"],
        sqexp_kernel=cfg["sqexp_kernel"], cat_int_kernel=cfg["cat_int_kernel"],
        bin_int_kernel=cfg["bin_int_kernel"], covariate_missing_val=cfg["covariate_missing_val"],
        id_covariate=cfg["id_covariate"])


def model(cfg: dict, state: dict, dtype):
    """The configuration's VAE with the ``vae.*`` weights of ``state``."""
    from lvae_torch.models.vae import make_vae

    vae = make_vae(cfg["type_nnet"], cfg["latent_dim"], cfg["num_dim"], vy_init=cfg["vy_init"],
                   dropout=cfg["dropout"], dropout_input=cfg["dropout_input"], dtype=dtype)
    vae.load_state_dict({k[4:]: v for k, v in state.items() if k.startswith("vae.")})
    return vae


def leaves(trainables) -> dict:
    """The network's and the GP hyperparameters' leaves by the names of the
    state that :class:`perfbench.inputs.Maker` makes."""
    gp = trainables.gp
    out = {"vae." + k: p for k, p in trainables.vae.named_parameters()}
    out.update({"gp.kp0.raw_scale": gp.kp0.raw_scale,
                "gp.kp0.raw_lengthscale": gp.kp0.raw_lengthscale,
                "gp.kp1.raw_scale": gp.kp1.raw_scale,
                "gp.kp1.raw_lengthscale": gp.kp1.raw_lengthscale,
                "gp.raw_noise": gp.raw_noise})
    return out


class Cohort:
    """The cohort made from the seed, as the trainers take a dataset."""

    def __init__(self, data: dict):
        self.data, self.labels, self.mask = data["frames"], data["labels"], data["pixmask"]


def host(state: dict) -> dict:
    return {k: v.detach().cpu().clone() for k, v in state.items()}


class Phases:
    """Host-clock seconds of each set-up phase, for the standard error."""

    def __init__(self):
        self.t = time.perf_counter()
        self.done: List[tuple] = []

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.done.append((name, now - self.t))
        self.t = now
