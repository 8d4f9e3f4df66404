"""Command-line entry points (port of lvae_tpu.cli).

``python -m lvae_torch.cli --f=config.txt``         — L-VAE training
``python -m lvae_torch.cli pretrain --f=cfg.txt``   — VAE pre-training
``python -m lvae_torch.cli generate ...``           — Health MNIST generation

Flag files use the reference's format (one ``--flag=value`` per line,
kernel structure as Python literals), so a reference user's configs work
unchanged. Every command runs on the CUDA card; ``--device=cpu`` (read
before the flag file is parsed, anywhere on the command line) runs it on
the CPU through the plain versions of the kernels. With ``--data_mesh``
or ``--latent_mesh`` above 1, training runs one process per rank:

``torchrun --nproc_per_node=2 -m lvae_torch.cli --f=config.txt --data_mesh=2``
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import List, Tuple

from lvae_torch.config import LVAEConfig, VAEConfig, parse_flag_lines


def _print_config(cfg) -> None:
    for f in dataclasses.fields(cfg):
        print(f"{f.name}: {getattr(cfg, f.name)}")


def split_device(argv: List[str]) -> Tuple[str, List[str]]:
    """``(device, the other arguments)``: ``--device=<cuda|cpu>`` taken out
    of ``argv``; ``cuda`` by default."""
    device, rest = "cuda", []
    for arg in argv:
        if arg.startswith("--device="):
            device = arg.split("=", 1)[1]
        else:
            rest.append(arg)
    return device, rest


def main_lvae(argv, device: str = "cuda") -> int:
    cfg, unknown = parse_flag_lines(argv, LVAEConfig)
    for k, v in unknown.items():
        print(f"WARNING: unknown flag --{k}={v}")
    _print_config(cfg)
    import torch
    import torch.distributed as dist

    from lvae_torch.pipeline import LVAEPipeline
    from lvae_torch.utils.device import resolve_device

    dev = resolve_device(device)
    started = dist.is_initialized()
    try:
        pipeline = LVAEPipeline(cfg, device=dev)
        dev = pipeline.device
        name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
        where = "" if pipeline.mesh is None else f", {pipeline.mesh}"
        print(f"Running on device: {dev} ({name}){where}")
        pipeline.run()
    finally:
        if not started and dist.is_initialized():  # the group this run started
            dist.destroy_process_group()
    return 0


def main_pretrain(argv, device: str = "cuda") -> int:
    cfg, unknown = parse_flag_lines(argv, VAEConfig)
    for k, v in unknown.items():
        print(f"WARNING: unknown flag --{k}={v}")
    _print_config(cfg)
    if cfg.loss_function not in ("mse", "nll"):
        raise ValueError(f"Unknown loss function {cfg.loss_function!r}: expected mse or nll")
    import torch

    from lvae_torch.data.datasets import load_dataset
    from lvae_torch.models.vae import make_vae
    from lvae_torch.pipeline import check_ported
    from lvae_torch.train.pretrain import VAEPretrainer
    from lvae_torch.utils.checkpoint import save_checkpoint

    check_ported(cfg)
    dataset = load_dataset(cfg, "train")
    print(f"Length of dataset:  {len(dataset)}")
    model = make_vae(
        cfg.type_nnet, cfg.latent_dim, cfg.num_dim or dataset.num_dim,
        vy_init=cfg.vy_init, dropout=cfg.dropout, dropout_input=cfg.dropout_input,
        generator=torch.Generator().manual_seed(cfg.seed),
        T=cfg.T or None, hidden_dim=cfg.hidden_dim, type_rnn=cfg.type_rnn,
    )
    pre = VAEPretrainer(
        model, dataset, loss_function=cfg.loss_function,
        learning_rate=cfg.learning_rate, dropout=cfg.dropout > 0, seed=cfg.seed,
        vy_fixed=cfg.vy_fixed, device=device,
    )
    test_dataset = load_dataset(cfg, "test") if cfg.run_tests else None

    def callback(trainer, epoch, metrics):
        # every 25 epochs: test MSE, reconstruction grid, checkpoint
        if epoch % 25 == 0:
            if cfg.run_tests and test_dataset is not None:
                from lvae_torch.evaluation.generation import vae_output
                from lvae_torch.evaluation.testing import vae_test

                vae_test(trainer.params, test_dataset, device=pre.device)
                vae_output(trainer.params, dataset, epoch, cfg.save_path, device=pre.device)
            save_checkpoint(os.path.join(cfg.save_path, f"model_params_vae_{epoch}.ckpt"),
                            trainer.params)

    pre.fit(cfg.epochs, callback=callback)
    save_checkpoint(os.path.join(cfg.save_path, "model_params_vae.ckpt"), pre.params)
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device, argv = split_device(argv)
    if argv and argv[0] == "pretrain":
        return main_pretrain(argv[1:], device)
    if argv and argv[0] == "generate":
        from lvae_torch.data.healthmnist import main as gen_main

        gen_main(argv[1:])
        return 0
    return main_lvae(argv, device)


if __name__ == "__main__":
    raise SystemExit(main())
