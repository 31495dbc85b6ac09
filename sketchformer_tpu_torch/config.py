"""Static model configuration, field for field the JAX ``SketchformerConfig``.

A plain dataclass: the JAX one lives in a module that imports flax, which
the port never imports. ``tests/test_torch_config.py`` pins the fields and
defaults to the JAX class.
"""

from __future__ import annotations

import dataclasses

import torch

from sketchformer_tpu_torch.utils.hparams import HParams

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class SketchformerConfig:
    vocab_size: int = 10004        # grid 100x100 + specials
    num_classes: int = 345
    max_len: int = 256
    d_model: int = 256
    num_layers: int = 8
    num_heads: int = 8
    dff: int = 512
    dropout: float = 0.1
    lowerdim: int = 256
    bottleneck_mode: str = "attn"  # attn | mean | direct
    num_queries: int = 4
    use_continuous: bool = False
    num_mixtures: int = 20
    attn_impl: str = "xla"         # xla (composed) | pallas (fused kernel)
    norm_first: bool = True
    qk_norm: bool = False          # per-head q/k LayerNorm
    dtype: str = "float32"         # trunk compute dtype

    @property
    def compute_dtype(self) -> torch.dtype:
        try:
            return _DTYPES[self.dtype]
        except KeyError:
            raise ValueError(f"unsupported compute dtype {self.dtype!r}; "
                             f"one of {sorted(_DTYPES)}") from None

    @classmethod
    def default_hparams(cls) -> HParams:
        """Reference-style ``default_hparams()`` for k=v CLI overrides."""
        return HParams(**dataclasses.asdict(cls()))

    @classmethod
    def from_hparams(cls, hps: HParams) -> "SketchformerConfig":
        return cls(**hps.values())
