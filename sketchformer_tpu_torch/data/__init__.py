"""Host data path: stroke-3 tools, tokenizers, bucketed batch builders and
the loader registry (copies of ``sketchformer_tpu.data``, which the port does
not import)."""

from sketchformer_tpu_torch.data import tfrecord  # noqa: F401  registers tfrecord_stroke3
