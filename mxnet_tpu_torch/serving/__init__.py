"""Dynamic-batching inference serving (counterpart of
``mxnet_tpu/serving``): :class:`Server` around one Block, the bucket grid,
the request plumbing, the predictor cache, hot reload
(:class:`ParamStore`), the continuous-batching decode engine
(:mod:`.decode`) and the replica tier: :class:`ReplicaPool` of in-process
and subprocess replicas (``python -m mxnet_tpu_torch.serving worker``)
behind the health-routed :class:`Router`, over the wire protocol of
:mod:`.wire`."""
from __future__ import annotations

from .batcher import (DeadlineExceeded, PendingResponse, Request,
                      RequestCancelled, RequestError, ServerOverloaded,
                      ServerStopped, SlotsExhausted)
from .buckets import BucketGrid
from .cache import Predictor, PredictorCache
from .decode import (DecodeConfig, DecodeEngine, DecodeModel, DecodeStream,
                     TinyLM)
from .pool import (DeployInProgress, LocalReplica, PoolConfig, ProcReplica,
                   ReplicaPool, ReplicaState, ReplicaUnavailable)
from .reload import ParamStore
from .router import Router, RouterConfig, RouterResponse
from .server import Server, ServerConfig

__all__ = ["BucketGrid", "DeadlineExceeded", "DecodeConfig", "DecodeEngine",
           "DecodeModel", "DecodeStream", "DeployInProgress", "LocalReplica",
           "ParamStore", "PendingResponse", "PoolConfig", "Predictor",
           "PredictorCache", "ProcReplica", "ReplicaPool", "ReplicaState",
           "ReplicaUnavailable", "Request", "RequestCancelled",
           "RequestError", "Router", "RouterConfig", "RouterResponse",
           "Server", "ServerConfig", "ServerOverloaded", "ServerStopped",
           "SlotsExhausted", "TinyLM"]
