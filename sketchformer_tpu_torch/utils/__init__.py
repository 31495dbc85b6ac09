"""Framework-neutral host utilities: hparams, registries, engine notes,
metric writers and notifiers (copies of ``sketchformer_tpu.utils``)."""

from sketchformer_tpu_torch.utils.hparams import HParams
from sketchformer_tpu_torch.utils.registry import Registry
