"""Model registry (reference: models/__init__.py get_model_by_name)."""

from sketchformer_tpu_torch.utils.registry import Registry

models: Registry = Registry("model")


def get_model_by_name(name: str):
    # the builders register themselves when the model module loads
    import sketchformer_tpu_torch.models.sketchformer  # noqa: F401

    return models.get(name)
