"""Model builders of the port."""
from . import attention_lm

__all__ = ["attention_lm"]
