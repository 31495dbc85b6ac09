"""sketchformer_tpu_torch: the PyTorch + CUDA port of ``sketchformer_tpu``.

Runs on one NVIDIA H100 (Hopper, ``sm_90a``). The JAX package next to it is
the reference; module names mirror it::

    sketchformer_tpu_torch/
      config.py   SketchformerConfig (same fields and defaults)
      convert.py  flax params -> state_dict, npz save/load, seeded init
      data/       stroke-3 tools, tokenizers, bucketed batch builders,
                  loaders, packed batches (copies of the JAX package's)
      native/     the C batch builder (a copy), built into native/_build/
      models/     embeddings, attention, stacks, bottleneck, heads, dropout
      ops/        hand-written CUDA kernels (csrc/) and their wrappers, the
                  train stacks' autograd Functions, MDN math
      infer/      embedding extraction, AR decode, SBIR metrics
      train/      losses, optimizer, train / eval steps, checkpoints, loop
      utils/      hparams, registries, engine notes, metric writers, the
                  card's timing helpers and the checks against plain routes
      tools/      the reference-weight importer and the benchmark's tools
      presets.py  the named experiment presets
      cli.py      prep-data / train / eval / embed / sbir / decode /
                  interpolate / bench (the benchmark's cells)

The package imports torch and never jax, flax, optax or orbax, nor any
module of ``sketchformer_tpu``: what it needs of the JAX package's
framework-neutral modules it keeps as its own copies, under the same
paths (``tests/test_torch_imports.py`` walks every module to hold this).
"""

__version__ = "0.1.0"
