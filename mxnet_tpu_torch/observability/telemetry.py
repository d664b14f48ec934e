"""Device-side train telemetry: computed after each fused step, fetched
rarely.

PyTorch counterpart of ``mxnet_tpu/observability/telemetry.py``.  The
signals a degrading run shows first — the gradient global norm, the
parameter norm, the step loss, the AMP loss scale and the non-finite and
skipped-step counts — are computed by :func:`compute` as f32 scalars on the
step's device right after ``Executor.fused_step``'s update (the reference
computes them inside its fused program), kept on the device across steps,
and read on the host only every ``TPUMX_TELEMETRY_EVERY`` steps
(:func:`publish`).  Nothing here writes a tensor the step uses: the step's
results are the same bits with telemetry on or off.

``TPUMX_TELEMETRY=0`` switches it off: the step then computes nothing
extra.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

__all__ = ["enabled", "every", "compute", "publish", "ACCUMULATING"]

#: telemetry keys summed across steps (on the device); the rest are the
#: last step's values
ACCUMULATING = ("nonfinite_grad_count", "skip_step")

_PUBLISH_NAME = {
    "grad_norm": "train_grad_norm",
    "param_norm": "train_param_norm",
    "loss": "train_loss",
    "loss_scale": "train_loss_scale",
    "nonfinite_grad_count": "train_nonfinite_grads_total",
    "skip_step": "train_skip_steps_total",
}


def enabled() -> bool:
    """Telemetry is on by default; ``TPUMX_TELEMETRY=0`` turns it off."""
    return os.environ.get("TPUMX_TELEMETRY", "1") != "0"


def every() -> int:
    """Steps between host reads of the device scalars (default 50)."""
    try:
        return max(1, int(os.environ.get("TPUMX_TELEMETRY_EVERY", "50")))
    except ValueError:
        return 50


def _sqsum(tensors, device) -> torch.Tensor:
    """Σ x² over the floating tensors, in f32, as one device scalar."""
    ts = [t for t in tensors if t.is_floating_point()]
    if not ts:
        return torch.zeros((), dtype=torch.float32, device=device)
    norms = torch._foreach_norm(ts, 2, dtype=torch.float32)
    return torch.stack(norms).square().sum()


def compute(outs, grads: Dict[str, torch.Tensor],
            params: Dict[str, torch.Tensor], scaler_state=None,
            nonfinite: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
            sharded_grads: Iterable[str] = (),
            sharded_params: Iterable[str] = (),
            global_sum: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
    """The telemetry dict of f32 device scalars (the reference's
    ``compute_in_program`` keys).

    ``grads`` are the step's summed (post-all-reduce, unscaled) gradients
    and ``params`` the updated parameters; the step loss is the mean of
    the first floating output (outputs whole, as ``fused_step`` returns
    them on a mesh: the global batch's mean, the reference's ``pmean``
    over dp).  On a mesh, ``sharded_grads`` and ``sharded_params`` name
    the tensors that are this rank's block, and ``global_sum`` sums a list
    of scalars over the axes they are cut on: their square sums and
    non-finite counts are summed there, so every rank reports the whole
    arrays' values (the reference's ``psum_axes`` rule).  ``nonfinite``:
    this rank's ``(count over the other gradients, count over the block
    gradients)`` when the loss-scale check already counted them, else
    counted here."""
    dev = next(iter(params.values())).device if params else None
    on_mesh = global_sum is not None

    def split(tree, names):
        names = set(names) if on_mesh else set()
        return ([v for n, v in tree.items() if n not in names],
                [v for n, v in tree.items() if n in names])

    g_rep, g_blk = split(grads, sharded_grads)
    p_rep, p_blk = split(params, sharded_params)
    g_sq, p_sq = _sqsum(g_rep, dev), _sqsum(p_rep, dev)
    if nonfinite is None:
        from ..amp.loss_scaler import LossScaler

        nonfinite = (LossScaler.nonfinite_count(g_rep),
                     LossScaler.nonfinite_count(g_blk))
    f32 = dict(device=dev, dtype=torch.float32)
    rep_nonfin, blk_nonfin = (n.to(**f32) for n in nonfinite)
    if on_mesh:
        parts = global_sum([_sqsum(g_blk, dev), _sqsum(p_blk, dev),
                            blk_nonfin])
        g_sq, p_sq, nonfin = (g_sq + parts[0], p_sq + parts[1],
                              rep_nonfin + parts[2])
    else:
        nonfin = rep_nonfin + blk_nonfin
    loss = torch.zeros((), **f32)
    for o in outs:
        if o.is_floating_point():
            loss = o.detach().float().mean().to(dev)
            break
    tele = {
        "grad_norm": torch.sqrt(g_sq),
        "param_norm": torch.sqrt(p_sq),
        "loss": loss,
        "nonfinite_grad_count": nonfin,
        "skip_step": (nonfin > 0).to(torch.float32),
    }
    if scaler_state is not None:
        tele["loss_scale"] = scaler_state[0].detach().to(**f32)
    return tele


def publish(values: Dict[str, object], prefix: str = "") -> Dict[str, float]:
    """Read the device scalars on the host (THE one sync: call at log
    boundaries only) and set them as registry gauges.  Returns the floats."""
    from . import registry

    reg = registry()
    out = {}
    for k, v in values.items():
        try:
            fv = float(v)
        except (TypeError, ValueError):
            continue
        out[k] = fv
        name = _PUBLISH_NAME.get(k, f"train_{k}")
        reg.gauge(prefix + name,
                  help="device-side fused-train-step telemetry").set(fv)
    return out
