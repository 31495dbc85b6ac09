"""The hand-written Hopper kernels' wrappers.

Each kernel's wrapper adds one to its module's ``LAUNCHES`` count where it
launches the kernel; :func:`counted_modules` is the one list of those
modules, read by the multi-process harness and ``chip_smoke.py``.
"""

from __future__ import annotations

from typing import Dict


def counted_modules():
    """The modules whose kernel wrappers count their launches (each holds
    ``LAUNCHES`` and ``reset_launches``)."""
    from sketchformer_tpu_torch.ops import (
        attention_train,
        decode_attention,
        decode_chunk,
        decode_step,
        dropout_prng,
        encoder_stack,
        flash_attention,
        norm_train,
        optimizer,
        token_ce,
    )

    return (encoder_stack, decode_chunk, decode_attention, attention_train,
            norm_train, token_ce, dropout_prng, flash_attention, decode_step,
            optimizer)


def reset_launches() -> None:
    """Set every kernel wrapper's launch count in this process to 0."""
    for m in counted_modules():
        m.reset_launches()


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch count in this process."""
    return {k: v for m in counted_modules() for k, v in m.LAUNCHES.items()}
