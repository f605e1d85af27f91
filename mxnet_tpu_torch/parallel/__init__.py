"""Parallel training and long-context attention (counterpart of
``mxnet_tpu/parallel/``): one-device meshes (:mod:`.mesh`), the
one-program training step ``ShardedTrainer`` (:mod:`.sharded`), and the
single-device part of ``ring_attention`` (the dense oracle and
blockwise, i.e. flash, attention)."""
from __future__ import annotations

from . import mesh, ring_attention, sharded
from .mesh import (Mesh, PartitionSpec, current_mesh, make_mesh,
                   mesh_signature, use_mesh)
from .ring_attention import attention_reference, blockwise_attention
from .sharded import ShardedTrainer, project_spec

__all__ = ["Mesh", "PartitionSpec", "ShardedTrainer", "attention_reference",
           "blockwise_attention", "current_mesh", "make_mesh", "mesh",
           "mesh_signature", "project_spec", "ring_attention", "sharded",
           "use_mesh"]
