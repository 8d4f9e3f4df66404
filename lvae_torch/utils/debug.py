"""Runtime sanity checks of the GP algebra (port of lvae_tpu.utils.debug).

A health report over one batch's GP operators, and a trainer-level guard
that raises with a per-tensor report the moment the training state holds a
non-finite value, instead of writing a broken checkpoint.
"""

from __future__ import annotations

from typing import Dict

import torch

from lvae_torch.ops.elbo import GPBlockOperators
from lvae_torch.train.state import Trainables, tree_finite


def gp_health(ops: GPBlockOperators) -> Dict[str, torch.Tensor]:
    """Conditioning diagnostics of one batch's GP operators, as device
    tensors (no host synchronisation).

    On the K1 route (``kernels_cuda/b_chain.py``) B and chol(B) never leave
    the kernel (``ops.B``/``ops.LB`` are None), so the evidence there is
    B⁻¹'s finiteness and log|B|: a failed pivot makes both non-finite."""
    diag_lk = torch.diagonal(ops.LK0zz, dim1=-2, dim2=-1)
    out = {
        "finite_iK0zz": torch.isfinite(ops.iK0zz).all(),
        "min_LK0zz_pivot": diag_lk.min(),
        "max_iK0zz": ops.iK0zz.abs().max(),
    }
    if ops.B is not None and ops.LB is not None:
        out.update({
            "finite_B": torch.isfinite(ops.B).all(),
            "finite_LB": torch.isfinite(ops.LB).all(),
            "min_LB_pivot": torch.diagonal(ops.LB, dim1=-2, dim2=-1).min(),
        })
    else:
        out.update({
            "finite_iB": torch.isfinite(ops.iB).all(),
            "finite_logdet_B": torch.isfinite(ops.logdet_B).all(),
        })
    return out


def _named_tensors(tr: Trainables):
    for name, p in tr.vae.named_parameters():
        yield f"vae.{name}", p
    for kp_name, kp in (("kp0", tr.gp.kp0), ("kp1", tr.gp.kp1)):
        for field, t in zip(kp._fields, kp):
            yield f"gp.{kp_name}.{field}", t
    yield "gp.raw_noise", tr.gp.raw_noise
    for name in ("m", "h_factor", "z"):
        if getattr(tr, name) is not None:
            yield name, getattr(tr, name)


def assert_state_finite(tr: Trainables, where: str = "") -> None:
    """Raise ``FloatingPointError`` naming the non-finite tensors of the
    trainables ``tr``."""
    if bool(tree_finite(tr)):
        return
    bad = [name for name, t in _named_tensors(tr) if not bool(torch.isfinite(t).all())]
    raise FloatingPointError(
        f"Non-finite training state{f' at {where}' if where else ''}: "
        + ", ".join(bad[:10])
        + ("..." if len(bad) > 10 else "")
    )
