"""Typed configuration for the L-VAE framework + reference flag-file shim.

Replaces the reference's argparse/``locals().update`` flag system
(parse_model_args.py:9-153, LVAE.py:38). Configs are plain dataclasses; the
``--f=<file>`` flag files the reference uses (one ``--flag=value`` per line,
kernel structure as Python literals, parse_model_args.py:9-15, 74-79) load
directly via :func:`load_flag_file`, so a reference user's configs keep
working.
"""

from __future__ import annotations

import ast
import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


def _str2bool(v: str) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise ValueError(f"Boolean value expected, got {v!r}")


@dataclass
class LVAEConfig:
    """Runtime parameters for L-VAE training (parse_model_args.py:18-102)."""

    # data paths
    data_source_path: str = "./data"
    save_path: str = "./results"
    results_path: Optional[str] = None
    csv_file_data: Optional[str] = None
    csv_file_label: Optional[str] = None
    mask_file: Optional[str] = None
    csv_file_test_data: Optional[str] = None
    csv_file_test_label: Optional[str] = None
    test_mask_file: Optional[str] = None
    csv_file_prediction_data: Optional[str] = None
    csv_file_prediction_label: Optional[str] = None
    prediction_mask_file: Optional[str] = None
    csv_file_validation_data: Optional[str] = None
    csv_file_validation_label: Optional[str] = None
    validation_mask_file: Optional[str] = None
    csv_file_generation_data: Optional[str] = None
    csv_file_generation_label: Optional[str] = None
    generation_mask_file: Optional[str] = None
    dataset_type: str = "HealthMNIST"  # HealthMNIST | RotatedMNIST | Physionet

    # model
    latent_dim: int = 2
    hidden_dim: int = 64
    num_dim: Optional[int] = None
    type_nnet: str = "conv"  # conv | simple | rnn
    type_rnn: str = "lstm"  # lstm | gru (rnn encoder variant)
    vy_init: float = 1.0
    vy_fixed: bool = False
    dropout: float = 0.5
    dropout_input: float = 0.2

    # GP prior
    id_covariate: int = 0
    M: int = 10
    P: int = 0
    T: int = 0
    varying_T: bool = False
    cat_kernel: List[int] = field(default_factory=list)
    bin_kernel: List[int] = field(default_factory=list)
    sqexp_kernel: List[int] = field(default_factory=list)
    cat_int_kernel: List[dict] = field(default_factory=list)
    bin_int_kernel: List[dict] = field(default_factory=list)
    covariate_missing_val: List[dict] = field(default_factory=list)
    constrain_scales: bool = False

    # training
    epochs: int = 1000
    weight: float = 1.0
    num_samples: int = 1
    loss_function: str = "mse"  # mse | nll
    type_KL: str = "GPapprox_closed"  # closed | GPapprox | GPapprox_closed
    mini_batch: bool = False
    hensman: bool = False
    variational_inference_training: bool = False
    natural_gradient: bool = True
    natural_gradient_lr: float = 0.01
    subjects_per_batch: int = 20
    learning_rate: float = 1e-3
    eps: float = 1e-6

    # ops / infra
    model_params: str = "model_params.pth"
    gp_model_folder: str = "./pretrainedVAE"
    memory_dbg: bool = False
    generate_plots: bool = False  # parsed-but-unused in the reference too; warned
    iter_num: int = 1  # parsed-but-unused in the reference too; warned
    # Validation / test-MSE cadence (epochs). The reference parses a
    # test_freq flag defaulting to 50 that it never reads and hardcodes the
    # cadence to 25 (parse_model_args.py:73 vs training.py:150); we honour
    # the flag, defaulting to the reference's actual behaviour.
    test_freq: int = 25
    run_tests: bool = False
    run_validation: bool = False
    generate_images: bool = False

    # TPU-native knobs (no reference equivalent)
    dtype: str = "float32"  # compute dtype for GP algebra
    model_dtype: str = ""  # VAE compute dtype. '' = the GP dtype unless
    # LVAE_MODEL_BF16=1 forces bf16 (models/vae.auto_model_dtype).
    # 'float32' pins f32; 'bfloat16' runs the VAE's layers in bf16 with f32
    # parameters, losses and GP algebra.
    seed: int = 0
    data_mesh: int = 1  # devices on the 'data' (subject) mesh axis
    latent_mesh: int = 1  # devices on the 'latent' mesh axis
    checkpoint_every: int = 25
    # pickle (zero-dependency single file) | orbax (atomic directory commit)
    # | orbax_async (training continues while the host writes)
    checkpoint_backend: str = "pickle"
    learn_inducing: bool = False  # optimise inducing points (hensman only)
    # Ragged-T cohorts: pad subjects into <=T_buckets length buckets instead
    # of one global T_max (SURVEY §7 step 7). 1 = single bucket. Per-batch
    # BOUND VALUES are exact either way (masking makes padding exact;
    # buckets only cut the padded-Cholesky waste, elbo_functions.py:219-307
    # cost ∝ Σ T_s³) — but the minibatch STREAM differs: buckets are
    # visited in fixed ascending-cap order and batches never mix length
    # bands, so the stochastic (m, H)/Adam trajectory is not sample-for-
    # sample identical to the uniformly shuffled single-bucket trainer.
    T_buckets: int = 1
    profile: bool = False
    auto_recover: bool = False  # restore last good checkpoint on non-finite state
    debug_nans: bool = False  # raise with diagnostics if state degrades

    def kernel_spec_kwargs(self) -> Dict[str, Any]:
        return dict(
            cat_kernel=self.cat_kernel,
            bin_kernel=self.bin_kernel,
            sqexp_kernel=self.sqexp_kernel,
            cat_int_kernel=self.cat_int_kernel,
            bin_int_kernel=self.bin_int_kernel,
            covariate_missing_val=self.covariate_missing_val,
        )

    def validate(self) -> "LVAEConfig":
        assert not (self.hensman and self.mini_batch), (
            "hensman and mini_batch are mutually exclusive (LVAE.py:40)"
        )
        assert self.loss_function in ("mse", "nll"), (
            f"Unknown loss function {self.loss_function} (LVAE.py:41)"
        )
        assert not self.varying_T or self.hensman, (
            "varying_T can't be used without hensman (LVAE.py:42)"
        )
        assert self.type_KL in ("closed", "GPapprox", "GPapprox_closed", "other")
        assert self.checkpoint_backend in ("pickle", "orbax", "orbax_async")
        assert self.T_buckets >= 1, "T_buckets must be >= 1"
        assert self.T_buckets == 1 or self.hensman, (
            "T_buckets > 1 requires the hensman regime (the bucketed epoch "
            "program is the SVI trainer's; standard regimes are full-batch "
            "fixed-T)"
        )
        assert self.T_buckets == 1 or self.type_nnet != "rnn", (
            "T_buckets > 1 is incompatible with the RNN encoder (it consumes "
            "fixed-T subject-major sequences)"
        )
        # Flags the reference parses but never reads anywhere
        # (parse_model_args.py:71-72, grep-verified): accept them for
        # flag-file compatibility, but tell the user instead of silently
        # ignoring a knob they set.
        if self.generate_plots:
            print(
                "Warning: --generate_plots is accepted for reference-config "
                "compatibility but unused (the reference never reads it; "
                "use --generate_images)."
            )
        if self.iter_num != 1:
            print(
                "Warning: --iter_num is accepted for reference-config "
                "compatibility but unused (the reference never reads it; "
                "point --save_path/--results_path at per-run directories)."
            )
        return self


@dataclass
class VAEConfig:
    """Runtime parameters for VAE pre-training (parse_model_args.py:105-143)."""

    data_source_path: str = "./data"
    save_path: str = "./results"
    csv_file_data: Optional[str] = None
    csv_file_label: Optional[str] = None
    mask_file: Optional[str] = None
    csv_file_test_data: Optional[str] = None
    csv_file_test_label: Optional[str] = None
    test_mask_file: Optional[str] = None
    dataset_type: str = "HealthMNIST"
    latent_dim: int = 2
    hidden_dim: int = 64
    id_covariate: int = 0
    T: int = 0
    varying_T: bool = False
    epochs: int = 1000
    num_dim: Optional[int] = None
    type_nnet: str = "conv"
    type_rnn: str = "lstm"
    loss_function: str = "nll"
    iter_num: int = 1
    vy_fixed: bool = False
    vy_init: float = 1.0
    run_tests: bool = False
    dropout: float = 0.5
    dropout_input: float = 0.2
    learning_rate: float = 1e-3
    dtype: str = "float32"
    seed: int = 0


_LITERAL_FIELDS = {
    "cat_kernel",
    "bin_kernel",
    "sqexp_kernel",
    "cat_int_kernel",
    "bin_int_kernel",
    "covariate_missing_val",
}


def parse_flag_lines(lines, cls=LVAEConfig):
    """Parse reference-style ``--flag=value`` lines into a config instance.

    Unknown flags are collected and returned so callers can warn (the
    reference silently accepted anything argparse knew about).
    """
    values, unknown = _parse_flag_values(lines, cls)
    cfg = cls(**values)
    return cfg, unknown


def _parse_flag_values(lines, cls) -> Tuple[Dict[str, Any], Dict[str, str]]:
    """Flag lines → dict of only the flags EXPLICITLY set.

    Nested ``--f=file`` recurses and merges just the sub-file's explicit
    flags (argparse's LoadFromFile replays the file's lines in place,
    parse_model_args.py:9-15 — it never resets untouched flags to their
    defaults, so neither do we)."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    values: Dict[str, Any] = {}
    unknown: Dict[str, str] = {}
    for raw in lines:
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if not line.startswith("--"):
            raise ValueError(f"Cannot parse flag line: {line!r}")
        body = line[2:]
        if "=" in body:
            name, val = body.split("=", 1)
        else:
            name, val = body, "true"
        name = name.strip()
        val = val.strip()
        if name == "f":  # nested flag file
            with open(val) as f:
                sub_values, sub_unknown = _parse_flag_values(
                    f.read().splitlines(), cls
                )
            values.update(sub_values)
            unknown.update(sub_unknown)
            continue
        if name not in fields:
            unknown[name] = val
            continue
        ftype = str(fields[name].type)
        base = ftype.replace("Optional[", "").rstrip("]")
        if name in _LITERAL_FIELDS:
            values[name] = ast.literal_eval(val)
        elif base == "bool":
            values[name] = _str2bool(val)
        elif base == "int":
            values[name] = int(val)
        elif base == "float":
            values[name] = float(val)
        else:
            values[name] = val
    return values, unknown


def load_flag_file(path: str, cls=LVAEConfig) -> Tuple[Any, Dict[str, str]]:
    """Load a reference flag file (``python LVAE.py --f=cfg.txt`` format)."""
    with open(path) as f:
        return parse_flag_lines(f.read().splitlines(), cls)
