"""mxnet_tpu_torch.fault — failure as a first-class runtime concern.

PyTorch counterpart of ``mxnet_tpu.fault``:

- :mod:`.preemption` — one process-wide signal hub for SIGTERM/SIGINT;
  ``GenerationService`` and ``GenerationRouter`` use it to drain in-flight
  work while rejecting queued requests.
- :mod:`.inject` — the deterministic fault-injection harness driven by
  the ``TPUMX_FAULT_*`` environment specs; the generation engine and the
  router fire its step-failure and replica-kill faults.
"""
from __future__ import annotations

from .inject import (FaultInjectedError, FaultInjector, corrupt_checkpoint,
                     injector)
from .preemption import (DEFAULT_SIGNALS, PreemptionHandler,
                         install_shutdown_hook, signals_supported)
from . import inject
from . import preemption

__all__ = ["FaultInjector", "FaultInjectedError", "injector",
           "corrupt_checkpoint", "PreemptionHandler",
           "install_shutdown_hook", "signals_supported", "DEFAULT_SIGNALS",
           "inject",
           "preemption"]
