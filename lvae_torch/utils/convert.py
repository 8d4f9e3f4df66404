"""Carry trained weights over from the JAX package (numpy arrays in, tensors out).

Layout conversions (flax → torch), the inverse of the reference-checkpoint
import in the JAX package's ``utils/torch_compat.py``:

  Conv               kernel [kH, kW, I, O]         → weight [O, I, kH, kW]
  ConvTranspose      kernel [kH, kW, I, O], flipped → weight [I, O, kH, kW]
                     (PyTorch's transposed conv correlates with the spatially
                     flipped kernel relative to lax.conv_transpose)
  Dense              kernel [I, O]                 → weight [O, I]

The ConvVAE's ``fc1`` consumes, and ``fc4`` produces, the flattened feature
map, whose order is H-W-C in flax (NHWC) and C-H-W in PyTorch (NCHW): their
input and output axes are permuted accordingly. Nothing here imports JAX:
the caller passes the flax params tree with numpy-convertible leaves.

:func:`hensman_state_from_jax` and :func:`standard_state_from_jax` carry a
whole training state over, the optimizer's moments included (optax's Adam
or the fused flat Adam), so that both packages can start from one state.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, List, Optional

import numpy as np
import torch

from lvae_torch.ops.kernels import KernelParams
from lvae_torch.train import state as st
from lvae_torch.train.standard import StandardState
from lvae_torch.train.state import GPParams

_LINEARS = ("fc1", "fc21", "fc211", "fc221", "fc3", "fc31", "fc4")


def vae_state_dict_from_jax(params, dtype=np.float32) -> Dict[str, torch.Tensor]:
    """flax ConvVAE/SimpleVAE params tree → the port's ``state_dict``, in
    ``dtype`` (float32 unless a float64 test asks for more)."""

    def _np(arr) -> np.ndarray:
        return np.asarray(arr, dtype=dtype)

    p = params["params"]
    sd: Dict[str, np.ndarray] = {}
    for name in _LINEARS:
        sd[f"{name}.weight"] = _np(p[name]["kernel"]).T
        sd[f"{name}.bias"] = _np(p[name]["bias"])
    if "conv1" in p:
        for name in ("conv1", "conv2"):
            sd[f"{name}.weight"] = _np(p[name]["kernel"]).transpose(3, 2, 0, 1)
            sd[f"{name}.bias"] = _np(p[name]["bias"])
        for name in ("deconv1", "deconv2"):
            k = _np(p[name]["kernel"])  # [kH, kW, I, O], flipped
            sd[f"{name}.weight"] = k[::-1, ::-1].transpose(2, 3, 0, 1)
            sd[f"{name}.bias"] = _np(p[name]["bias"])
        feat = sd["fc1.weight"].shape[1] // 32
        f = int(round(feat ** 0.5))
        w = sd["fc1.weight"]  # [300, f·f·32] in H-W-C input order
        sd["fc1.weight"] = w.reshape(-1, f, f, 32).transpose(0, 3, 1, 2).reshape(w.shape[0], -1)
        w = sd["fc4.weight"]  # [f·f·32, 300] rows in H-W-C order
        sd["fc4.weight"] = w.reshape(f, f, 32, -1).transpose(2, 0, 1, 3).reshape(-1, w.shape[1])
        sd["fc4.bias"] = sd["fc4.bias"].reshape(f, f, 32).transpose(2, 0, 1).reshape(-1)
    sd["raw_log_vy"] = _np(p["raw_log_vy"])
    return {k: torch.tensor(np.ascontiguousarray(v)) for k, v in sd.items()}


def gp_params_from_jax(gp, dtype=torch.float32) -> GPParams:
    """A JAX ``GPParams`` (``kp0``, ``kp1``, ``raw_noise``; numpy-convertible
    leaves) → the port's :class:`GPParams` on the CPU."""

    def t(x) -> torch.Tensor:
        return torch.tensor(np.asarray(x), dtype=dtype)

    def kp(k) -> KernelParams:
        return KernelParams(raw_scale=t(k.raw_scale), raw_lengthscale=t(k.raw_lengthscale))

    return GPParams(kp0=kp(gp.kp0), kp1=kp(gp.kp1), raw_noise=t(gp.raw_noise))


def _adam_state(opt_state):
    """optax's ``ScaleByAdamState`` or the JAX package's ``FusedAdamState``
    (each has ``count``, ``mu``, ``nu``) inside an optax state tuple, or
    None."""
    if all(hasattr(opt_state, k) for k in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for sub in opt_state:
            found = _adam_state(sub)
            if found is not None:
                return found
    return None


def _optional_tensor(x, dtype, device) -> Optional[torch.Tensor]:
    return None if x is None else torch.tensor(np.asarray(x), dtype=dtype, device=device)


def _trainables_from_jax(tr, model, dtype, device) -> st.Trainables:
    """JAX ``Trainables`` (or a tree of the same layout, such as Adam's
    moments) → the port's tensors; the VAE leaves go into ``model`` when
    it is a module, else they are returned as a ``state_dict``."""

    def t(x) -> Optional[torch.Tensor]:
        return _optional_tensor(x, dtype, device)

    gp = GPParams(
        kp0=KernelParams(t(tr.gp.kp0.raw_scale), t(tr.gp.kp0.raw_lengthscale)),
        kp1=KernelParams(t(tr.gp.kp1.raw_scale), t(tr.gp.kp1.raw_lengthscale)),
        raw_noise=t(tr.gp.raw_noise),
    )
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    sd = {k: v.to(device) for k, v in vae_state_dict_from_jax(tr.vae, np_dtype).items()}
    if model is not None:
        model.load_state_dict(sd)
        vae = model
    else:
        vae = sd
    return st.Trainables(vae=vae, gp=gp, m=t(tr.m), h_factor=t(tr.h_factor),
                         z=t(getattr(tr, "z", None)))


def _in_port_order(tree, model, dtype, device) -> List[torch.Tensor]:
    """The tensors of a Trainables-shaped JAX tree in the order of
    ``Trainables.parameters()``."""
    mt = _trainables_from_jax(tree, None, dtype, device)
    return [mt.vae[n] for n, _ in model.named_parameters()] + [
        x for x in (*mt.gp.tensors(), mt.m, mt.h_factor, mt.z) if x is not None
    ]


def _unravel_like(flat: np.ndarray, tree):
    """A tree shaped like ``tree`` whose leaves are consecutive slices of
    ``flat``, in the order ``jax.flatten_util.ravel_pytree`` lays them out:
    mapping keys sorted, tuple fields in order, ``None`` empty."""
    pos = 0

    def rebuild(node):
        nonlocal pos
        if node is None:
            return None
        if isinstance(node, Mapping):
            return {k: rebuild(node[k]) for k in sorted(node)}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(rebuild(x) for x in node))
        if isinstance(node, (tuple, list)):
            return type(node)(rebuild(x) for x in node)
        shape = np.shape(node)
        size = int(np.prod(shape))
        leaf = flat[pos:pos + size].reshape(shape)
        pos += size
        return leaf

    return rebuild(tree)


def _optimizer_from_jax(opt_state, jax_trainables, model, params, learning_rate,
                        dtype, device) -> torch.optim.Optimizer:
    """The port's optimizer over ``params`` carrying the JAX optimizer's
    state: a ``FusedAdamState`` (flat moments, padded on a TPU) becomes
    :class:`FusedAdam`'s ``mu``/``nu``/``count``; optax's Adam moments become
    ``torch.optim.Adam``'s ``exp_avg``/``exp_avg_sq``/``step``."""
    adam = _adam_state(opt_state)
    fused = adam is not None and hasattr(adam.mu, "shape")  # one flat array
    opt = st.make_optimizer(params, learning_rate, kind="fused" if fused else "adam")
    if adam is None:
        return opt
    count = int(np.asarray(adam.count))
    if fused:
        n = opt.mu.numel()
        for buf, flat in ((opt.mu, adam.mu), (opt.nu, adam.nu)):
            tree = _unravel_like(np.asarray(flat)[:n], jax_trainables)
            buf.copy_(torch.cat([x.reshape(-1) for x in
                                 _in_port_order(tree, model, dtype, device)]))
        opt.count = count
        return opt
    moments = [_in_port_order(tree, model, dtype, device) for tree in (adam.mu, adam.nu)]
    sd = opt.state_dict()
    sd["state"] = {
        i: {"step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": mu, "exp_avg_sq": nu}
        for i, (mu, nu) in enumerate(zip(*moments))
    }
    opt.load_state_dict(sd)
    return opt


def _trainables_and_optimizer(state, model, learning_rate, dtype, device):
    model.to(device=device, dtype=dtype)
    tr = _trainables_from_jax(state.trainables, model, dtype, device)
    params = list(tr.parameters())
    for p in params:
        p.requires_grad_(True)
    opt = _optimizer_from_jax(state.opt_state, state.trainables, model, params,
                              learning_rate, dtype, device)
    return tr, opt


def hensman_state_from_jax(state, model, learning_rate: float = 1e-3,
                           seed: int = 0, dtype=torch.float32,
                           device="cpu") -> st.HensmanState:
    """A JAX ``HensmanState`` (numpy-convertible leaves) → the port's.

    The VAE weights are loaded into ``model`` (moved to ``device``/``dtype``);
    the GP parameters, m/h_factor, inducing points, ``m_nat``, ``H_nat`` and
    ``step`` are carried over, and the optimizer with its moments (see
    :func:`standard_state_from_jax`). JAX's random key has no counterpart:
    the new state's CPU generator is seeded from ``seed``."""
    tr, opt = _trainables_and_optimizer(state, model, learning_rate, dtype, device)
    return st.HensmanState(
        trainables=tr, m_nat=_optional_tensor(state.m_nat, dtype, device),
        H_nat=_optional_tensor(state.H_nat, dtype, device), opt_state=opt,
        rng=torch.Generator().manual_seed(seed), step=int(np.asarray(state.step)),
    )


def standard_state_from_jax(state, model, learning_rate: float = 1e-3,
                            seed: int = 0, dtype=torch.float32,
                            device="cpu") -> StandardState:
    """A JAX ``StandardState`` (numpy-convertible leaves) → the port's.

    The VAE weights are loaded into ``model`` and the GP parameters and
    ``step`` carried over. The optimizer follows the JAX one: a
    ``FusedAdamState`` (flat moments in ``ravel_pytree`` order, padded on a
    TPU) becomes :class:`~lvae_torch.kernels_cuda.adam.FusedAdam` with its
    moments laid out in ``Trainables.parameters()`` order; optax's Adam
    becomes ``torch.optim.Adam`` with ``exp_avg``/``exp_avg_sq``/``step``.
    The new state's CPU generator is seeded from ``seed``."""
    tr, opt = _trainables_and_optimizer(state, model, learning_rate, dtype, device)
    return StandardState(trainables=tr, opt_state=opt,
                         rng=torch.Generator().manual_seed(seed),
                         step=int(np.asarray(state.step)))
