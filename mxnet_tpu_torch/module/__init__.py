"""Modules: the high-level training interface."""
from .base_module import BaseModule
from .executor_group import DataParallelExecutorGroup
from .module import Module

__all__ = ["BaseModule", "DataParallelExecutorGroup", "Module"]
