"""Static views of the port's programs (the counterpart of
``mxnet_tpu/analysis``).

Only the artifact is here so far (:mod:`.artifact`): one program traced
by ``torch.export`` into a :class:`~.artifact.ProgramArtifact`, built by
the one function :func:`~.artifact.artifact_from_export` behind every
export and artifact surface (``Predictor.export`` / ``artifact``,
``DecodePredictor.*_artifact``, ``ProgramSpec.artifact``), and
:func:`~.artifact.kernel_ops`, the count of the kernels' operator nodes
in an artifact's graph.  The reference's passes (``framework.py``,
``passes.py``, ...) are not ported yet.
"""
from .artifact import ProgramArtifact, artifact_from_export, kernel_ops

__all__ = ["ProgramArtifact", "artifact_from_export", "kernel_ops"]
