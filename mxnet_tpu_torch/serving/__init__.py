"""Dynamic-batching inference serving (counterpart of
``mxnet_tpu/serving``): :class:`Server` around one Block, the bucket grid,
the request plumbing, the predictor cache, hot reload
(:class:`ParamStore`), the continuous-batching decode engine
(:mod:`.decode`) and the replica tier: :class:`ReplicaPool` of in-process
and subprocess replicas (``python -m mxnet_tpu_torch.serving worker``)
behind the health-routed :class:`Router`, over the wire protocol of
:mod:`.wire`; the tenant :class:`Fleet` (weight paging, per-tenant
breakers, SLO admission), the canary :class:`DeployController` and the
journal summary :func:`serving_report`."""
from __future__ import annotations

from .batcher import (DeadlineExceeded, PendingResponse, Request,
                      RequestCancelled, RequestError, ServerOverloaded,
                      ServerStopped, SlotsExhausted)
from .buckets import BucketGrid
from .cache import Predictor, PredictorCache
from .decode import (DecodeConfig, DecodeEngine, DecodeModel, DecodeStream,
                     TinyLM)
from .deploy import DeployConfig, DeployController
from .fleet import Fleet, FleetConfig, SLOClass, TenantQuarantined
from .pool import (DeployInProgress, LocalReplica, PoolConfig, ProcReplica,
                   ReplicaPool, ReplicaState, ReplicaUnavailable)
from .reload import ParamStore
from .report import serving_report
from .router import Router, RouterConfig, RouterResponse
from .server import Server, ServerConfig

__all__ = ["BucketGrid", "DeadlineExceeded", "DecodeConfig", "DecodeEngine",
           "DecodeModel", "DecodeStream", "DeployConfig", "DeployController",
           "DeployInProgress", "Fleet", "FleetConfig", "LocalReplica",
           "ParamStore", "PendingResponse", "PoolConfig", "Predictor",
           "PredictorCache", "ProcReplica", "ReplicaPool", "ReplicaState",
           "ReplicaUnavailable", "Request", "RequestCancelled",
           "RequestError", "Router", "RouterConfig", "RouterResponse",
           "SLOClass", "Server", "ServerConfig", "ServerOverloaded",
           "ServerStopped", "SlotsExhausted", "TenantQuarantined", "TinyLM",
           "serving_report"]
