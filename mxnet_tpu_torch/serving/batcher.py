"""Serving error types and backpressure policy names.

The part of ``mxnet_tpu/serving/batcher.py`` the generation engine uses;
the micro-batcher itself comes with a later slice.
"""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["ServingError", "QueueFullError", "DeadlineExceededError",
           "RequestShedError", "ServingClosedError", "BACKPRESSURE_POLICIES"]

BACKPRESSURE_POLICIES = ("block", "reject", "shed_oldest")


class ServingError(MXNetError):
    """Base class for serving-layer failures."""


class QueueFullError(ServingError):
    """Bounded queue is full and the policy is ``reject`` (or a blocking
    submit timed out)."""


class DeadlineExceededError(ServingError):
    """The request's deadline expired before it finished."""


class RequestShedError(ServingError):
    """The request was evicted by the ``shed_oldest`` policy."""


class ServingClosedError(ServingError):
    """submit() after stop()/drain."""
