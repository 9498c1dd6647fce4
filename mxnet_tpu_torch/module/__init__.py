"""Modules: the high-level training interface."""
from .base_module import BaseModule, BatchEndParam
from .bucketing_module import BucketingModule
from .executor_group import DataParallelExecutorGroup
from .module import Module
from .pipeline_module import PipelineModule
from .python_module import PythonLossModule, PythonModule
from .sequential_module import SequentialModule

__all__ = ["BaseModule", "BatchEndParam", "BucketingModule",
           "DataParallelExecutorGroup", "Module", "PipelineModule",
           "PythonLossModule",
           "PythonModule", "SequentialModule"]
