"""Dynamic loss scaling inside the fused train step.

PyTorch counterpart of ``mxnet_tpu/amp/loss_scaler.py`` (Micikevicius et
al., 2018, section 4).  ``Executor.fused_step(loss_scaler=)`` scales the
head cotangent, counts the non-finite gradient entries, unscales, skips
the whole update on overflow and advances the scaler's ``(scale,
good_steps)``.  That state is a pair of f32 scalar tensors kept on the
step's device and updated there (:meth:`next_state`); the step reads the
finite verdict on the host once.  The hyperparameters are constants of
the scaler (:meth:`static_key`).
"""
from __future__ import annotations

import torch

__all__ = ["LossScaler"]


class LossScaler:
    """Functional loss scaler.

    ``dynamic=True`` (the default) multiplies the scale by
    ``growth_factor`` after ``growth_interval`` consecutive finite steps
    and by ``backoff_factor`` on any overflow (a non-finite gradient),
    always skipping that step's update.  ``dynamic=False`` keeps the scale
    constant but still skips non-finite steps."""

    def __init__(self, init_scale: float = 2.0 ** 15,
                 growth_factor: float = 2.0, backoff_factor: float = 0.5,
                 growth_interval: int = 2000, dynamic: bool = True,
                 max_scale: float = 2.0 ** 24, min_scale: float = 1.0):
        self.init_scale = float(init_scale)
        self.growth_factor = float(growth_factor)
        self.backoff_factor = float(backoff_factor)
        self.growth_interval = int(growth_interval)
        self.dynamic = bool(dynamic)
        self.max_scale = float(max_scale)
        self.min_scale = float(min_scale)
        self._state = None  # (scale, good_steps) f32 scalar tensors

    # -- state ----------------------------------------------------------------
    def static_key(self) -> tuple:
        """The hyperparameters, as the reference keys its fused program
        with them."""
        return ("loss_scaler", self.init_scale, self.growth_factor,
                self.backoff_factor, self.growth_interval, self.dynamic,
                self.max_scale, self.min_scale)

    def state(self, device=None) -> tuple:
        """``(scale, good_steps)``, made at the first call (on ``device``,
        default the CPU) and moved to ``device`` when another is given."""
        if self._state is None:
            self._state = (torch.tensor(self.init_scale, dtype=torch.float32,
                                        device=device),
                           torch.tensor(0.0, dtype=torch.float32,
                                        device=device))
        elif device is not None and self._state[0].device != \
                torch.device(device):
            self._state = tuple(s.to(device) for s in self._state)
        return self._state

    def set_state(self, state) -> None:
        """Commit the step's new ``(scale, good_steps)``."""
        self._state = tuple(state)

    def reset(self) -> None:
        self._state = None

    @property
    def scale_value(self) -> float:
        """The current scale, read on the host."""
        return float(self.state()[0])

    @property
    def good_steps(self) -> int:
        return int(float(self.state()[1]))

    # -- the step's pieces ------------------------------------------------------
    @staticmethod
    def scale_cotangent(ct: torch.Tensor, scale) -> torch.Tensor:
        """The loss scale applied to one floating output's cotangent."""
        return (ct * scale).to(ct.dtype)

    @staticmethod
    def unscale(grad: torch.Tensor, scale) -> torch.Tensor:
        """The scale taken off one gradient, computed in f32 and kept in
        the gradient's dtype (inf and nan stay non-finite)."""
        return (grad.float() / scale).to(grad.dtype)

    @staticmethod
    def nonfinite_count(grads) -> torch.Tensor:
        """The number of non-finite entries of the floating gradients: an
        f32 scalar, summable over a mesh (a boolean is not).  The
        gradients of one device and dtype are concatenated and counted in
        one pass: a handful of launches whatever their number (one by
        one it was four launches a gradient)."""
        groups = {}
        for g in grads.values() if isinstance(grads, dict) else grads:
            if g.is_floating_point():
                groups.setdefault((g.device, g.dtype), []).append(
                    g.reshape(-1))
        total = None
        for flat in groups.values():
            n = torch.logical_not(torch.isfinite(torch.cat(flat))).sum(
                dtype=torch.float32)
            total = n if total is None else total + n.to(total.device)
        if total is None:
            return torch.tensor(0.0)
        return total

    def next_state(self, state, finite) -> tuple:
        """The scale update: back off on overflow, grow after
        ``growth_interval`` clean steps (the scale is constant for
        ``dynamic=False``).  ``finite`` is a bool tensor or a bool."""
        scale, good = state
        finite = torch.as_tensor(finite, device=scale.device)
        zero = torch.zeros_like(good)
        if not self.dynamic:
            return (scale.clone(), torch.where(finite, good + 1.0, zero))
        grown = good + 1.0 >= float(self.growth_interval)
        scale_ok = torch.where(
            grown, torch.clamp(scale * self.growth_factor,
                               max=self.max_scale), scale)
        good_ok = torch.where(grown, zero, good + 1.0)
        return (torch.where(finite, scale_ok,
                            torch.clamp(scale * self.backoff_factor,
                                        min=self.min_scale)),
                torch.where(finite, good_ok, zero))
