"""Modules: the high-level training interface."""
from .base_module import BaseModule, BatchEndParam
from .bucketing_module import BucketingModule
from .executor_group import DataParallelExecutorGroup
from .module import Module

__all__ = ["BaseModule", "BatchEndParam", "BucketingModule",
           "DataParallelExecutorGroup", "Module"]
