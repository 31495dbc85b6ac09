"""Named experiment presets matching BASELINE.json's five configs.

(Reference parity: the reference selects model + dataloader by CLI string
with per-model ``default_hparams``; presets bundle the same choices under
the names the benchmark knows.)

    tok2tok_cls_cpu   config 1: dict-tokenized encoder -> cls logits, CPU-OK
    cont2cont_mdn     config 2: continuous input, MDN/GMM head
    ar_decode         config 3: greedy KV-cached AR reconstruction
    sbir              config 4: embedding extraction over a 345-class gallery
    pretrain_full     config 5: full multi-task pretraining over shards

Every preset is overridable with ``--hparams k=v,...`` and ``--loader-arg``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

from sketchformer_tpu_torch.utils.registry import Registry

presets: Registry = Registry("preset")


@dataclasses.dataclass(frozen=True)
class Preset:
    name: str
    description: str
    task: str                      # train | decode | embed
    model_overrides: Dict[str, Any]
    loader: str
    loader_kwargs: Dict[str, Any]
    loop_overrides: Dict[str, Any]


def _reg(p: Preset) -> Preset:
    presets.register(p.name)(p)
    return p


TOK2TOK_CLS_CPU = _reg(Preset(
    name="tok2tok_cls_cpu",
    description="dict-tokenized encoder forward -> classification logits "
                "(CPU-runnable CI workhorse)",
    task="train",
    model_overrides=dict(
        d_model=128, num_layers=4, num_heads=8, dff=256, lowerdim=128,
        max_len=192, dropout=0.1, dtype="float32", attn_impl="xla"),
    loader="synthetic",
    loader_kwargs=dict(
        num_classes=16, sketches_per_epoch=4096, batch_size=32,
        buckets=(96, 192), token_mode=True),
    loop_overrides=dict(total_steps=300, eval_every=100, save_every=100,
                        warmup_steps=100, peak_scale=4.0),
))

CONT2CONT_MDN = _reg(Preset(
    name="cont2cont_mdn",
    description="continuous-input Sketchformer with MDN/GMM output head",
    task="train",
    model_overrides=dict(
        d_model=256, num_layers=8, num_heads=8, dff=512, lowerdim=256,
        max_len=192, dropout=0.1, use_continuous=True, num_mixtures=20,
        dtype="bfloat16", attn_impl="pallas", qk_norm=True),
    loader="synthetic",
    loader_kwargs=dict(
        num_classes=32, sketches_per_epoch=8192, batch_size=64,
        buckets=(96, 192), token_mode=False),
    loop_overrides=dict(total_steps=2000, eval_every=250, save_every=500,
                        warmup_steps=500, peak_scale=2.0),
))

AR_DECODE = _reg(Preset(
    name="ar_decode",
    description="autoregressive reconstruction: greedy KV-cached decode "
                "from bottleneck embedding",
    task="decode",
    model_overrides=dict(
        d_model=256, num_layers=8, num_heads=8, dff=512, lowerdim=256,
        max_len=192, dropout=0.0, dtype="bfloat16", attn_impl="pallas"),
    loader="synthetic",
    loader_kwargs=dict(
        num_classes=16, sketches_per_epoch=1024, batch_size=64,
        buckets=(192,), token_mode=True),
    loop_overrides=dict(),
))

SBIR = _reg(Preset(
    name="sbir",
    description="SBIR retrieval embedding extraction over a 345-class "
                "gallery (bottleneck pooling)",
    task="embed",
    model_overrides=dict(
        d_model=256, num_layers=8, num_heads=8, dff=512, lowerdim=256,
        max_len=192, dropout=0.0, dtype="bfloat16", attn_impl="pallas",
        num_classes=345),
    loader="synthetic",
    loader_kwargs=dict(
        num_classes=345, sketches_per_epoch=345 * 16, batch_size=64,
        buckets=(192,), token_mode=True),
    loop_overrides=dict(),
))

PRETRAIN_FULL = _reg(Preset(
    name="pretrain_full",
    description="full multi-task pretraining: reconstruction + "
                "classification over QuickDraw millions-scale shards",
    task="train",
    model_overrides=dict(
        d_model=256, num_layers=8, num_heads=8, dff=512, lowerdim=256,
        max_len=192, dropout=0.1, num_classes=345, dtype="bfloat16",
        attn_impl="pallas", qk_norm=True),
    loader="distributed_stroke3",
    loader_kwargs=dict(batch_size=256, buckets=(64, 96, 128, 192),
                       token_mode=True),
    loop_overrides=dict(total_steps=300_000, eval_every=2000,
                        save_every=5000, warmup_steps=10_000),
))


def get_preset(name: str) -> Preset:
    return presets.get(name)
