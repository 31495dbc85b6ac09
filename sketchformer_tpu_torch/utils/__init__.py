"""Framework-neutral host utilities: hparams, registries, engine notes,
metric writers and notifiers (copies of ``sketchformer_tpu.utils``)."""
