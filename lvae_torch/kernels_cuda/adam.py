"""One-pass flat Adam: CUDA kernel K5, its plain version and the optimizer
that runs it.

The kernel (``lvae_torch/csrc/adam.cu``) replaces the Pallas TPU kernel
``lvae_tpu/kernels_pallas/adam.py:_adam_pallas``: over flat f32 ``m, v, g``
it writes ``m' = b1·m + (1−b1)·g``, ``v' = b2·v + (1−b2)·g²`` in place and
``Δ = −lr·(m'·c1)/(√(v'·c2) + eps)``, with the bias corrections
``c1 = 1/(1−b1ᵗ)``, ``c2 = 1/(1−b2ᵗ)`` passed as scalars, or computed by the
kernel from the step count t in device memory: optax.adam's form, not
``torch.optim.Adam``'s ``√v/√bc2``. The source's head note gives its bound
and design.

* :func:`fused_adam_update` — the kernel for a CUDA tensor (f32, flat,
  contiguous; anything else raises), the plain version for a CPU tensor.
* :func:`adam_reference` — the plain PyTorch version.
* :class:`FusedAdam` — the optimizer (the JAX package's ``fused_adam``):
  flat moments over a fixed parameter order and the step count on the
  device, one launch a step, so that a step captured in a CUDA graph
  advances the count and reads it on every replay.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from lvae_torch.kernels_cuda import build

SOURCE = "lvae_torch/csrc/adam.cu"
REPLACES = "lvae_tpu/kernels_pallas/adam.py:80"  # _adam_pallas

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("adam").lvae_adam_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_float] * 8 + [
            ctypes.c_void_p, ctypes.c_double, ctypes.c_double, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def bias_corrections(count: int, b1: float, b2: float) -> Tuple[float, float]:
    """``(1/(1−b1ᵗ), 1/(1−b2ᵗ))`` after ``count`` steps, in double."""
    return 1.0 / (1.0 - b1 ** count), 1.0 / (1.0 - b2 ** count)


def adam_reference(m, v, g, *, b1, b2, lr, eps, c1, c2):
    """Plain PyTorch version: ``(m', v', Δ)`` (``_adam_kernel``'s math)."""
    mo = b1 * m + (1.0 - b1) * g
    vo = b2 * v + (1.0 - b2) * (g * g)
    d = (-lr) * (mo * c1) / (torch.sqrt(vo * c2) + eps)
    return mo, vo, d


def fused_adam_update(m: torch.Tensor, v: torch.Tensor, g: torch.Tensor, *, b1: float,
                      b2: float, lr: float, eps: float, c1: Optional[float] = None,
                      c2: Optional[float] = None,
                      count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One Adam step over flat ``m, v, g [n]``: updates ``m`` and ``v`` in
    place and returns ``Δ``. The bias corrections are ``c1, c2`` or, given
    ``count`` (an int64 scalar on ``g``'s device, the steps taken including
    this one), :func:`bias_corrections` of it, computed on the device. CPU
    tensors: the plain version. CUDA tensors: the kernel, which takes f32
    contiguous vectors of one length on one device; anything else raises."""
    if (count is None) == (c1 is None or c2 is None):
        raise ValueError("fused_adam_update takes c1 and c2, or count")
    if g.device.type == "cpu":
        if count is not None:
            c1, c2 = bias_corrections(int(count), b1, b2)
        mo, vo, d = adam_reference(m, v, g, b1=b1, b2=b2, lr=lr, eps=eps, c1=c1, c2=c2)
        m.copy_(mo)
        v.copy_(vo)
        return d
    if not g.is_cuda:
        raise ValueError(f"fused_adam_update: unsupported device {g.device}")
    for name, t in (("m", m), ("v", v), ("g", g)):
        if t.device != g.device or t.dtype != torch.float32:
            raise ValueError(f"adam kernel: {name} must be float32 on {g.device}, got "
                             f"{t.dtype} on {t.device}")
        if t.ndim != 1 or t.shape != g.shape or not t.is_contiguous():
            raise ValueError(f"adam kernel: {name} must be a contiguous vector of "
                             f"{g.numel()}, got {tuple(t.shape)}")
    if count is not None and (count.device != g.device or count.dtype != torch.int64
                              or count.numel() != 1):
        raise ValueError(f"adam kernel: count must be one int64 on {g.device}, got "
                         f"{count.dtype} {tuple(count.shape)} on {count.device}")
    d = torch.empty_like(g)
    if g.numel() == 0:
        return d
    fn = _kernel()
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = fn(m.data_ptr(), v.data_ptr(), g.data_ptr(), d.data_ptr(), g.numel(),
                 b1, 1.0 - b1, b2, 1.0 - b2, lr, eps, c1 or 0.0, c2 or 0.0,
                 None if count is None else count.data_ptr(), b1, b2, stream)
    if err != 0:
        raise RuntimeError(f"adam kernel launch failed: cudaError {err}")
    fused_adam_update.launches += 1
    return d


fused_adam_update.launches = 0


class FusedAdam(torch.optim.Optimizer):
    """Adam with flat moments and one kernel launch a step.

    ``mu`` and ``nu`` are flat buffers over the parameters in the order
    given (the trainers pass ``Trainables.parameters()``; the state converter
    relies on that order) and ``count`` is the number of steps taken, kept
    on the parameters' device and advanced there, so that a step captured in
    a CUDA graph counts on every replay. A step concatenates the gradients
    once, runs :func:`fused_adam_update` and adds each parameter's slice of
    ``Δ`` to it. A parameter whose ``grad`` is None is passed through, as
    ``fused_adam`` passes ``None`` leaves: its moments and its value stay as
    they were."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps))
        if len(self.param_groups) != 1:
            raise ValueError("FusedAdam takes one parameter group")
        ps = self.param_groups[0]["params"]
        if len({(p.dtype, p.device) for p in ps}) != 1:
            raise ValueError("FusedAdam needs every parameter in one dtype on one device")
        self.step_count = torch.zeros((), dtype=torch.int64, device=ps[0].device)
        self.mu = torch.zeros(sum(p.numel() for p in ps), dtype=ps[0].dtype,
                              device=ps[0].device)
        self.nu = torch.zeros_like(self.mu)

    @property
    def count(self) -> int:
        """The steps taken (reading it waits for the card)."""
        return int(self.step_count)

    @count.setter
    def count(self, value: int) -> None:
        self.step_count.fill_(int(value))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        group = self.param_groups[0]
        ps = group["params"]
        b1, b2 = group["betas"]
        grads = [p.grad for p in ps]
        flat_g = torch.cat([(torch.zeros_like(p) if gr is None else gr).reshape(-1)
                            for p, gr in zip(ps, grads)])
        sizes = [p.numel() for p in ps]
        kept = []  # moments of the parameters without a gradient
        start = 0
        for size, gr in zip(sizes, grads):
            if gr is None:
                kept.append((start, start + size, self.mu[start:start + size].clone(),
                             self.nu[start:start + size].clone()))
            start += size
        self.step_count.add_(1)
        delta = fused_adam_update(self.mu, self.nu, flat_g, b1=b1, b2=b2, lr=group["lr"],
                                  eps=group["eps"], count=self.step_count)
        for a, b, mu, nu in kept:
            self.mu[a:b] = mu
            self.nu[a:b] = nu
        for p, gr, dp in zip(ps, grads, delta.split(sizes)):
            if gr is not None:
                p.add_(dp.view_as(p))
        return loss

    def state_dict(self):
        sd = super().state_dict()
        sd["flat"] = {"count": self.count, "mu": self.mu.clone(), "nu": self.nu.clone()}
        return sd

    def load_state_dict(self, state_dict):
        flat = state_dict["flat"]
        super().load_state_dict({k: v for k, v in state_dict.items() if k != "flat"})
        self.count = int(flat["count"])
        self.mu.copy_(flat["mu"])
        self.nu.copy_(flat["nu"])
