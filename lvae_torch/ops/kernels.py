"""Additive multi-output GP kernels over a declarative spec (port of
lvae_tpu.ops.kernels).

The additive kernel is a static, hashable :class:`KernelSpec`; one call of
:func:`kernel_matrix` evaluates the ``[L, N1, N2]`` stack for all latent
dimensions at once. Semantics:

* categorical factor: ``k(x1, x2) = 1 iff x1[col] == x2[col]`` (float ``==``);
* binary factor: ``k(x1, x2) = 1 iff x1[col] + x2[col] == 2``, also used for
  missing-covariate masks;
* squared-exponential factor on one column with a per-latent lengthscale;
* every additive component carries a per-latent positive scale;
* the components split into kernel0 (no id covariate) and kernel1 (id
  covariate), so kernel1 is block-diagonal over subjects.

Positive parameters use ``value = exp(min_log + softplus(raw - min_log))``
with ``min_log = -16``.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

MIN_LOG = -16.0
DEFAULT_SCALE = math.log(2.0)  # softplus(0), the GPyTorch ScaleKernel default
DEFAULT_LENGTHSCALE = 2.5
DEFAULT_NOISE = math.log(2.0)  # softplus(0), GPyTorch GaussianLikelihood default


def b_chain_from_env(value: str) -> Optional[bool]:
    """``$LVAE_BCHAIN`` → the K1 switch: ``1/true/on/yes`` True,
    ``0/false/off/no`` False, empty or ``auto`` None; anything else raises."""
    v = value.strip().lower()
    if v in ("1", "true", "on", "yes"):
        return True
    if v in ("0", "false", "off", "no"):
        return False
    if v in ("", "auto"):
        return None
    raise ValueError(f"LVAE_BCHAIN={value!r}: expected 1/0/true/false/on/off/yes/no/auto")


# Route switches of ops/elbo.gp_block_operators, the counterparts of the JAX
# package's ops.kernels.use_pallas_b_chain and use_pallas_block_pair.
# K1, the fused B-chain (kernels_cuda/b_chain.py): None (auto) runs it for
# CUDA tensors; True forces the route on every device (the CPU takes its
# plain version through BChain); False turns it off. $LVAE_BCHAIN sets it.
use_b_chain_kernel: Optional[bool] = b_chain_from_env(os.environ.get("LVAE_BCHAIN", ""))
# K4, the block-pair kernel (kernels_cuda/block_pair.py), where K1 does not
# run: off by default, as in the JAX package. As there, a batch outside
# block_pair.usable (f64, [C] parameters, a spec beyond the component table,
# a subject's covariates beyond a block's shared memory) takes the plain
# block kernels on every device, with the switch on.
use_block_pair_kernel: bool = False


class KernelComponent(NamedTuple):
    """One additive component: a product of simple factors on covariate columns.

    ``rbf_col``  — column index of the squared-exponential factor, or -1.
    ``eq_cols``  — columns compared with equality (categorical factors).
    ``and_cols`` — columns where both inputs must equal 1 (binary factors,
                   including missing-value mask columns).
    ``cat_mod``  — optional centred categorical factor ``(col, num_classes)``:
                   1 if equal else -1/(num-1). ``(-1, 0)`` = none.
    ``kind``     — informational tag.
    """

    kind: str
    rbf_col: int
    eq_cols: Tuple[int, ...]
    and_cols: Tuple[int, ...]
    cat_mod: Tuple[int, int] = (-1, 0)


class KernelSpec(NamedTuple):
    """A static, hashable description of an additive kernel."""

    components: Tuple[KernelComponent, ...]

    @property
    def num_components(self) -> int:
        return len(self.components)

    @property
    def has_rbf(self) -> Tuple[bool, ...]:
        return tuple(c.rbf_col >= 0 for c in self.components)


class KernelParams(NamedTuple):
    """Kernel hyper-parameters: ``raw_scale``/``raw_lengthscale`` ``[..., C]``,
    the leading dims (typically ``[L]``) one per latent GP. Lengthscale
    entries of non-RBF components exist but are unused."""

    raw_scale: torch.Tensor
    raw_lengthscale: torch.Tensor

    def to(self, *args, **kwargs) -> "KernelParams":
        return KernelParams(*(t.to(*args, **kwargs) for t in self))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # log(1 + e^x) without a linear cut-over, as jax.nn.softplus computes it
    return torch.logaddexp(x, torch.zeros_like(x))


def constrain(raw: torch.Tensor, min_log: float = MIN_LOG) -> torch.Tensor:
    """Raw → positive value: ``exp(min_log + softplus(raw - min_log))``."""
    return torch.exp(min_log + _softplus(raw - min_log))


def unconstrain(value, min_log: float = MIN_LOG) -> torch.Tensor:
    """Positive value → raw parameter (inverse of :func:`constrain`).

    A Python number is converted in float64."""
    if not isinstance(value, torch.Tensor):
        value = torch.as_tensor(value, dtype=torch.float64)
    y = torch.log(value) - min_log
    # softplus^{-1}(y) = log(expm1(y)); guard large y for overflow.
    inv = torch.where(y > 30.0, y, torch.log(torch.expm1(torch.clamp(y, 1e-12, 30.0))))
    return min_log + inv


def init_kernel_params(
    spec: KernelSpec,
    latent_dim: Optional[int] = None,
    scale: float = DEFAULT_SCALE,
    lengthscale: float = DEFAULT_LENGTHSCALE,
    dtype=torch.float32,
    device=None,
) -> KernelParams:
    """Initialise params for ``spec``; batched over ``latent_dim`` if given."""
    c = spec.num_components
    shape = (c,) if latent_dim is None else (latent_dim, c)
    raw_s = torch.full(shape, float(unconstrain(scale)), dtype=dtype, device=device)
    raw_l = torch.full(shape, float(unconstrain(lengthscale)), dtype=dtype, device=device)
    return KernelParams(raw_scale=raw_s, raw_lengthscale=raw_l)


def _component_base(
    comp: KernelComponent, x1: torch.Tensor, x2: torch.Tensor
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Data-only part of a component: discrete 0/1 matrix and squared distance.

    ``x1: [..., N1, Q]``, ``x2: [..., N2, Q]`` (same leading dims) →
    ``disc`` and ``sqdist`` ``[..., N1, N2]`` (each None when absent).
    """
    dtype = x1.dtype
    disc = None
    for col in comp.eq_cols:
        d = (x1[..., :, col, None] == x2[..., None, :, col]).to(dtype)
        disc = d if disc is None else disc * d
    for col in comp.and_cols:
        d = ((x1[..., :, col, None] + x2[..., None, :, col]) == 2.0).to(dtype)
        disc = d if disc is None else disc * d
    if comp.cat_mod[0] >= 0:
        col, num = comp.cat_mod
        eq = x1[..., :, col, None] == x2[..., None, :, col]
        # both branches in ``dtype``: Python-float branches of torch.where
        # would be rounded to float32 first
        other = torch.tensor(-1.0 / (num - 1), dtype=dtype, device=x1.device)
        d = torch.where(eq, torch.ones_like(other), other)
        disc = d if disc is None else disc * d
    sqdist = None
    if comp.rbf_col >= 0:
        diff = x1[..., :, comp.rbf_col, None] - x2[..., None, :, comp.rbf_col]
        sqdist = diff * diff
    return disc, sqdist


def additive_stack(
    spec: KernelSpec,
    scale: torch.Tensor,
    inv2l2: torch.Tensor,
    x1: torch.Tensor,
    x2: torch.Tensor,
) -> torch.Tensor:
    """The plain evaluation from CONSTRAINED ``scale`` and ``1/(2ℓ²)``
    ``[*P, C]``: ``K[*P, *X, N1, N2]``, summing each component's
    ``scale · exp(−sqdist/(2ℓ²)) · discrete factors`` in component order."""
    batch_shape = scale.shape[:-1]
    x_batch = x1.shape[:-2]
    n1, n2 = x1.shape[-2], x2.shape[-2]
    dtype = x1.dtype
    out = torch.zeros(batch_shape + x_batch + (n1, n2), dtype=dtype, device=x1.device)
    expand = (Ellipsis,) + (None,) * (len(x_batch) + 2)
    for c, comp in enumerate(spec.components):
        disc, sqdist = _component_base(comp, x1, x2)
        term = scale[..., c][expand]
        if sqdist is not None:
            term = term * torch.exp(-sqdist * inv2l2[..., c][expand])
        if disc is not None:
            term = term * disc
        elif sqdist is None:
            # a component with no factors is the constant 1
            term = term * torch.ones(x_batch + (n1, n2), dtype=dtype, device=x1.device)
        out = out + term
    return out


def kernel_matrix(
    spec: KernelSpec,
    params: KernelParams,
    x1: torch.Tensor,
    x2: torch.Tensor,
    mask1: Optional[torch.Tensor] = None,
    mask2: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Evaluate the additive kernel: ``K[*P, *X, N1, N2]``.

    ``*P`` are the leading batch dims of ``params`` (usually ``[L]``);
    ``x1 [*X, N1, Q]`` and ``x2 [*X, N2, Q]`` may share leading batch dims
    ``*X`` (e.g. subjects), which take the place of the JAX package's
    ``vmap``. ``mask1 [*X, N1]``/``mask2 [*X, N2]`` are optional 0/1
    validity vectors: rows/columns of padded points are zeroed.

    An empty spec evaluates to zeros. A large square evaluation on the card
    (f32, ``[L]`` parameters, no x batch dims, N1 and N2 at least 512: the
    JAX package's gate) runs kernel K3 (``kernels_cuda/kernel_matrix.py``);
    every other call takes the plain evaluation.
    """
    if spec.num_components > 0 and x1.is_cuda:
        from lvae_torch.kernels_cuda import kernel_matrix as kmk

        if kmk.usable(spec, params, x1, x2):
            return kmk.kernel_matrix_kernel(spec, params, x1, x2, mask1, mask2)
    dtype = x1.dtype
    scale = constrain(params.raw_scale.to(dtype))  # [*P, C]
    ls = constrain(params.raw_lengthscale.to(dtype))  # [*P, C]
    out = additive_stack(spec, scale, 0.5 / (ls * ls), x1, x2)
    if mask1 is not None:
        out = out * mask1.to(dtype)[..., :, None]
    if mask2 is not None:
        out = out * mask2.to(dtype)[..., None, :]
    return out


def block_kernel_matrix(
    spec: KernelSpec,
    params: KernelParams,
    xb: torch.Tensor,
    maskb: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-subject block kernel: ``xb [P, T, Q] → K [..., P, T, T]``, each
    subject's padded time block evaluated on its own (a broadcast over P)."""
    return kernel_matrix(spec, params, xb, xb, maskb, maskb)


def _mask_col(covariate: int, covariate_missing_val: Sequence[dict]) -> Optional[int]:
    for d in covariate_missing_val:
        if d["covariate"] == covariate:
            return d["mask"]
    return None


def _make_component(
    kind: str,
    rbf_col: int,
    eq_cols: Tuple[int, ...],
    and_cols: Tuple[int, ...],
    covariate_missing_val: Sequence[dict],
) -> KernelComponent:
    """Attach missing-value mask factors to a component."""
    extra_and = list(and_cols)
    for col in eq_cols + and_cols + ((rbf_col,) if rbf_col >= 0 else ()):
        m = _mask_col(col, covariate_missing_val)
        if m is not None:
            extra_and.append(m)
    return KernelComponent(
        kind=kind, rbf_col=rbf_col, eq_cols=eq_cols, and_cols=tuple(extra_and)
    )


def build_kernel_spec(
    cat_kernel: Sequence[int] = (),
    bin_kernel: Sequence[int] = (),
    sqexp_kernel: Sequence[int] = (),
    cat_int_kernel: Sequence[dict] = (),
    bin_int_kernel: Sequence[dict] = (),
    covariate_missing_val: Sequence[dict] = (),
) -> KernelSpec:
    """Single additive kernel from the config-file spec."""
    mv = covariate_missing_val
    comps = []
    for idx in cat_kernel:
        comps.append(_make_component("cat", -1, (idx,), (), mv))
    for idx in sqexp_kernel:
        comps.append(_make_component("rbf", idx, (), (), mv))
    for idx in bin_kernel:
        comps.append(_make_component("bin", -1, (), (idx,), mv))
    for d in cat_int_kernel:
        comps.append(
            _make_component("cat_rbf", d["cont_covariate"], (d["cat_covariate"],), (), mv)
        )
    for d in bin_int_kernel:
        comps.append(
            _make_component("bin_rbf", d["cont_covariate"], (), (d["bin_covariate"],), mv)
        )
    return KernelSpec(components=tuple(comps))


def split_kernel_spec(
    cat_kernel: Sequence[int] = (),
    bin_kernel: Sequence[int] = (),
    sqexp_kernel: Sequence[int] = (),
    cat_int_kernel: Sequence[dict] = (),
    bin_int_kernel: Sequence[dict] = (),
    covariate_missing_val: Sequence[dict] = (),
    id_covariate: int = 0,
) -> Tuple[KernelSpec, KernelSpec]:
    """(kernel0 without the id covariate, kernel1 with it).

    kernel1 collects every component that involves the subject-id covariate
    as a categorical factor, so it is block-diagonal over subjects — what
    makes the per-subject T×T factorisation exact.
    """
    mv = covariate_missing_val
    k0, k1 = [], []
    for idx in cat_kernel:
        comp = _make_component("cat", -1, (idx,), (), mv)
        (k1 if idx == id_covariate else k0).append(comp)
    for idx in sqexp_kernel:
        k0.append(_make_component("rbf", idx, (), (), mv))
    for idx in bin_kernel:
        k0.append(_make_component("bin", -1, (), (idx,), mv))
    for d in cat_int_kernel:
        comp = _make_component(
            "cat_rbf", d["cont_covariate"], (d["cat_covariate"],), (), mv
        )
        (k1 if d["cat_covariate"] == id_covariate else k0).append(comp)
    for d in bin_int_kernel:
        k0.append(
            _make_component("bin_rbf", d["cont_covariate"], (), (d["bin_covariate"],), mv)
        )
    return KernelSpec(components=tuple(k0)), KernelSpec(components=tuple(k1))


def _eye(m: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(m, dtype=like.dtype, device=like.device)


def add_adaptive_jitter(kzz: torch.Tensor, eps: float) -> torch.Tensor:
    """``K(z,z) + ε_eff·I`` — the serving inducing-matrix jitter.

    K0zz is often rank-deficient by construction (an RBF over a covariate
    with few distinct values duplicates inducing rows), so in float32 the
    jitter is floored relative to the kernel's scale
    (``max(eps, 3e-4·mean diag)``); float64 keeps the fixed ``eps``.
    """
    m = kzz.shape[-1]
    eye = _eye(m, kzz)
    if kzz.dtype == torch.float32:
        diag_mean = torch.sum(kzz * eye) / (kzz.numel() // m)
        eps_eff = torch.maximum(
            torch.tensor(eps, dtype=kzz.dtype, device=kzz.device), 3e-4 * diag_mean
        )
    else:
        eps_eff = eps
    return kzz + eps_eff * eye


def add_rel_jitter(h: torch.Tensor, rel: float = 3e-4) -> torch.Tensor:
    """Float32-only relative diagonal jitter for derived operators such as
    ``H = K0zz + Σ_s K0zx_s B_s⁻¹ K0xz_s``; float64 is a no-op."""
    if h.dtype != torch.float32:
        return h
    m = h.shape[-1]
    eye = _eye(m, h)
    diag_mean = torch.sum(h * eye) / (h.numel() // m)
    return h + (rel * diag_mean) * eye


def block_b_operator(
    spec1: KernelSpec,
    kp1: KernelParams,
    xb: torch.Tensor,
    mask: torch.Tensor,
    noise: torch.Tensor,
    k1_st: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``B = K1 + σ²I`` per subject block ``[L, P, T, T]``: σ_l² on real
    samples, a unit pivot on padding (so the padding adds 0 to log|B|)."""
    t = xb.shape[1]
    if k1_st is None:
        k1_st = block_kernel_matrix(spec1, kp1, xb, mask)
    diag = mask[None] * noise[:, None, None] + (1.0 - mask)[None]
    return k1_st + diag[..., None] * _eye(t, xb)


def join_specs(
    spec0: KernelSpec,
    spec1: KernelSpec,
    kp0: KernelParams,
    kp1: KernelParams,
) -> Tuple[KernelSpec, KernelParams]:
    """Concatenate the split kernels back into one additive kernel."""
    spec = KernelSpec(components=spec0.components + spec1.components)
    params = KernelParams(
        raw_scale=torch.cat([kp0.raw_scale, kp1.raw_scale], dim=-1),
        raw_lengthscale=torch.cat([kp0.raw_lengthscale, kp1.raw_lengthscale], dim=-1),
    )
    return spec, params
