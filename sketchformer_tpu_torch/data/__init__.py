"""Host data path: stroke-3 tools, tokenizers, bucketed batch builders and
the loader registry (copies of ``sketchformer_tpu.data``, which the port does
not import)."""

from sketchformer_tpu_torch.data import stroke3
from sketchformer_tpu_torch.data.tokenizer import GridTokenizer, DictionaryTokenizer
from sketchformer_tpu_torch.data.registry import dataloaders, get_dataloader_by_name
from sketchformer_tpu_torch.data import tfrecord  # noqa: F401  registers tfrecord_stroke3
