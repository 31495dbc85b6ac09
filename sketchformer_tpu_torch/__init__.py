"""sketchformer_tpu_torch: the PyTorch + CUDA port of ``sketchformer_tpu``.

Runs on one NVIDIA H100 (Hopper, ``sm_90a``). The JAX package next to it is
the reference; module names mirror it::

    sketchformer_tpu_torch/
      config.py   SketchformerConfig (same fields and defaults)
      convert.py  flax params -> state_dict, npz save/load, seeded init
      models/     embeddings, attention, encoder stack, bottleneck, heads
      ops/        hand-written CUDA kernels (csrc/) and their wrappers
      infer/      embedding extraction (kernel engine + serving loop)
      cli.py      embed / sbir subcommands

The package imports torch and never jax or flax; from ``sketchformer_tpu``
it uses only the framework-neutral data path, presets, SBIR metrics,
``HParams`` and ``note_engine``.
"""

__version__ = "0.1.0"
