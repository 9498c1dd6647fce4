"""Model builders of the port."""
from . import attention_lm, lstm_lm, resnet

__all__ = ["attention_lm", "lstm_lm", "resnet"]
