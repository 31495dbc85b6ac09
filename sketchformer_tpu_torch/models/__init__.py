"""The model, its config and the model registry.

``Sketchformer`` and ``SketchformerConfig`` load on first access: the
kernel wrappers under ``ops/`` import ``models.layers``, and the model
imports them, so loading the model with the package would close a cycle.
"""

from sketchformer_tpu_torch.models.registry import models, get_model_by_name


def __getattr__(name):
    if name in ("Sketchformer", "SketchformerConfig"):
        from sketchformer_tpu_torch.models import sketchformer

        return getattr(sketchformer, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
