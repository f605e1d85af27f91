"""Dynamic-batching inference serving (counterpart of
``mxnet_tpu/serving``): :class:`Server` around one Block, the bucket grid,
the request plumbing, the predictor cache and hot reload
(:class:`ParamStore`)."""
from __future__ import annotations

from .batcher import (DeadlineExceeded, PendingResponse, Request,
                      RequestError, ServerOverloaded, ServerStopped)
from .buckets import BucketGrid
from .cache import Predictor, PredictorCache
from .reload import ParamStore
from .server import Server, ServerConfig

__all__ = ["BucketGrid", "DeadlineExceeded", "ParamStore", "PendingResponse",
           "Predictor", "PredictorCache", "Request", "RequestError",
           "Server", "ServerConfig", "ServerOverloaded", "ServerStopped"]
