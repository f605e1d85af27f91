"""Module API (counterpart of ``mxnet_tpu/module/__init__.py``; ref
python/mxnet/module/__init__.py)."""
from .base_module import BaseModule
from .bucketing_module import BucketingModule
from .module import Module
from .sequential_module import SequentialModule

__all__ = ["BaseModule", "Module", "BucketingModule", "SequentialModule"]
