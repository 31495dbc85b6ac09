"""Early-exit decode latency of a trained model on the card: the port of
``tools/bench_decode_realistic.py``.

A fixed-horizon decode of random weights (the benchmark's
``decode_p50_ms``) never meets EOS, so it is the T=192 worst case. The
chunk engine exits early at a chunk boundary once every row has finished;
its p50 on sketches of typical length needs a model that terminates. This
tool:

1. trains the flagship token model on the synthetic gallery of
   ``bench_embed_pipeline`` by the fixed RECIPE (the JAX tool's, byte for
   byte, so RECIPE_HASH is equal too): fixed gallery, steps and schedule,
   under a wall-clock cap; the trained weights are cached under the
   temporary directory, keyed by the recipe's hash and checked against
   it, the parameter names and their shapes on load;
2. measures the decode p50 and minimum at B=64, T=192 over 3 held-out
   batches x 5 runs, through ``make_token_decoder(steps_per_call=K)`` at
   K = 8, 16 and 32, each K's first decode held to the float32
   teacher-forced forward of its picks, on the cluster kernel;
3. reports the decoded lengths (:func:`length_stats`).

    python -m sketchformer_tpu_torch.tools.bench_decode_realistic [--json]

``SKETCHFORMER_REALISTIC_CAP_S`` (default 900) caps the training's
seconds; past it the tool measures nothing rather than a half-trained
model.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import sys
import tempfile
import time

import numpy as np

EOS_ID = 2
DEC_T = 192
DEC_B = 64

# The committed training recipe (the JAX tool's). Changing ANY field
# changes the cache key, so a stale cache can never masquerade as the
# current recipe. Its 2,000 fixed steps were chosen on a TPU, where they
# reached >95% greedy EOS termination on held-out batches; the card's own
# termination is what ``length_stats`` reports.
RECIPE = dict(
    gallery_n=20_000, gallery_classes=64, gallery_seed=11, shard_seed=5,
    bucket=96, grid_resolution=100, train_b=512, steps=2000, seed=0,
    warmup_steps=600, peak_scale=2.0,
    d_model=256, num_layers=8, num_heads=2, dff=512, lowerdim=256,
    dropout=0.1, dtype="bfloat16", max_len=DEC_T,
)
RECIPE_HASH = hashlib.sha1(
    json.dumps(RECIPE, sort_keys=True).encode()).hexdigest()[:12]
TRAIN_B = RECIPE["train_b"]
HASH_KEY = "__recipe_hash__"


def params_cache() -> str:
    return os.path.join(tempfile.gettempdir(),
                        f"sketchformer_tpu_torch_flagship_{RECIPE_HASH}.npz")


def _note(msg):
    print(msg, file=sys.stderr, flush=True)


def _flagship(vocab_size, num_classes):
    from sketchformer_tpu_torch.config import SketchformerConfig
    from sketchformer_tpu_torch.models.sketchformer import Sketchformer

    cfg = SketchformerConfig(
        vocab_size=vocab_size, num_classes=num_classes,
        max_len=RECIPE["max_len"], d_model=RECIPE["d_model"],
        num_layers=RECIPE["num_layers"], num_heads=RECIPE["num_heads"],
        dff=RECIPE["dff"], dropout=RECIPE["dropout"],
        lowerdim=RECIPE["lowerdim"], dtype=RECIPE["dtype"],
        attn_impl="pallas")
    return Sketchformer(cfg)


def _save_params(path, model):
    """``convert.save_npz`` of the weights, with the recipe's hash as one
    more array."""
    import torch

    from sketchformer_tpu_torch.convert import save_npz

    sd = dict(model.state_dict())
    sd[HASH_KEY] = torch.tensor(list(RECIPE_HASH.encode()),
                                dtype=torch.float32)
    save_npz(path, sd)


def _load_params(path, model):
    """The cached weights if their recipe hash, names and shapes match
    ``model``'s, else None."""
    import torch

    from sketchformer_tpu_torch.convert import load_npz

    sd = load_npz(path)
    tag = sd.pop(HASH_KEY, None)
    if tag is None or bytes(tag.to(torch.uint8).tolist()) != \
            RECIPE_HASH.encode():
        return None
    want = model.state_dict()
    if set(sd) != set(want) or any(sd[k].shape != want[k].shape
                                   for k in want):
        return None
    return sd


def _gallery_and_val():
    from sketchformer_tpu_torch.data.registry import DistributedStroke3Loader
    from sketchformer_tpu_torch.tools.bench_embed_pipeline import (
        prepare_gallery,
    )

    data_dir = prepare_gallery(RECIPE["gallery_n"])
    loader = DistributedStroke3Loader(
        data_dir, batch_size=TRAIN_B, buckets=(RECIPE["bucket"],),
        grid_resolution=RECIPE["grid_resolution"], seed=RECIPE["seed"],
        process_index=0, process_count=1)
    val = []
    for b in loader.batch_iterator("valid"):
        if b["enc"].shape[0] == TRAIN_B:
            val.append(b)
        if len(val) >= 4:
            break
    if not val:  # 20k gallery's valid split yields partial batches only
        for b in loader.batch_iterator("valid"):
            val.append(b)
            if len(val) >= 4:
                break
    return loader, val


def get_trained_flagship(max_seconds: float = 300.0, verbose: bool = True,
                         device="cuda"):
    """(model in eval mode on ``device``, val batches) trained by RECIPE,
    or (None, None) if the wall-clock cap fires before the fixed step count
    completes (the benchmark then skips the section rather than report a
    half-trained model)."""
    from itertools import cycle

    import torch

    from sketchformer_tpu_torch.convert import init_params
    from sketchformer_tpu_torch.infer.decode import make_token_decoder
    from sketchformer_tpu_torch.train.step import (
        batch_to_device,
        create_train_state,
        make_train_step,
    )

    dev = torch.device(device)
    loader, val = _gallery_and_val()
    model = _flagship(loader.vocab_size, loader.num_classes)
    cache = params_cache()
    if os.path.exists(cache):
        cached = _load_params(cache, model)
        if cached is not None:
            if verbose:
                _note(f"using cached trained params ({RECIPE_HASH})")
            model.load_state_dict(cached)
            return model.to(dev).eval(), val

    model.load_state_dict(init_params(model.config, RECIPE["seed"]))
    model.to(dev)
    train_batches = []
    for b in loader.batch_iterator("train"):
        if b["enc"].shape[0] == TRAIN_B:
            train_batches.append(batch_to_device(b, dev))
        if len(train_batches) >= 48:
            break
    state = create_train_state(model, RECIPE["seed"],
                               warmup_steps=RECIPE["warmup_steps"],
                               peak_scale=RECIPE["peak_scale"])
    step = make_train_step(state)
    probe_enc = torch.from_numpy(val[0]["enc"][:DEC_B]).to(dev)
    feed = cycle(train_batches)
    t0 = time.perf_counter()
    done_steps = 0
    while done_steps < RECIPE["steps"]:
        chunk = min(250, RECIPE["steps"] - done_steps)
        for _ in range(chunk):
            m = step(next(feed))
        done_steps += chunk
        loss = m["loss"].item()
        dt = time.perf_counter() - t0
        if verbose:
            # a decoder copies the weights it runs, so one for each probe
            model.eval()
            ids = make_token_decoder(model, max_len=DEC_T)(
                probe_enc).cpu().numpy()
            term = float((ids == EOS_ID).any(axis=1).mean())
            _note(f"step {done_steps}/{RECIPE['steps']}: loss {loss:.3f}, "
                  f"EOS-terminated {term:.0%} ({dt:.0f}s)")
        if dt > max_seconds and done_steps < RECIPE["steps"]:
            _note(f"wall-clock cap {max_seconds:.0f}s hit at step "
                  f"{done_steps}; skipping (no partial cache written)")
            return None, None
    _save_params(cache, model)
    return model.eval(), val


def length_stats(ids: np.ndarray) -> dict:
    """Decoded lengths of (B, T) ids: the share of rows that emitted EOS,
    and the mean and 90th percentile of each row's length (up to and
    including its first EOS; T for a row without one)."""
    ids = np.asarray(ids)
    has = (ids == EOS_ID).any(axis=1)
    first = np.where(has, np.argmax(ids == EOS_ID, axis=1) + 1, ids.shape[1])
    return dict(terminated_frac=round(float(has.mean()), 3),
                len_mean=round(float(first.mean()), 1),
                len_p90=int(np.percentile(first, 90)))


def measure(model, val, ks=(8, 16, 32), reps=5, verbose=True):
    """p50 and min decode ms per chunk K over held-out batches:
    {f'decode_p50_ms_realistic_K{k}', f'decode_min_ms_realistic_K{k}'},
    the first K's :func:`length_stats` and the recipe's hash."""
    import torch

    from sketchformer_tpu_torch.infer.decode import make_token_decoder
    from sketchformer_tpu_torch.utils.checks import (
        launched,
        plain_f32_copy,
        teacher_forced_check,
    )

    dev = next(model.parameters()).device
    judge = plain_f32_copy(model)
    out = {}
    encs = [torch.from_numpy(b["enc"][:DEC_B]).to(dev) for b in val[:3]]
    lengths = None
    for k in ks:
        dec = make_token_decoder(model, max_len=DEC_T, steps_per_call=k)
        # K=8 and K=32 too on the cluster kernel, never the per-row one
        ids = launched(("decode_chunk",), lambda: dec(encs[0]),
                       dev.type == "cuda", cluster_only=True)
        teacher_forced_check(f"decode_realistic K={k}", judge, encs[0], None,
                             ids, dtype=model.config.compute_dtype)
        lat = []
        for enc in encs:
            for _ in range(reps):
                t0 = time.perf_counter()
                ids = dec(enc).cpu().numpy()
                lat.append(time.perf_counter() - t0)
        out[f"decode_p50_ms_realistic_K{k}"] = round(
            float(np.percentile(lat, 50)) * 1e3, 2)
        # the fastest run bounds the decode's device and launch time from
        # above, whatever the host did during the others
        out[f"decode_min_ms_realistic_K{k}"] = round(
            float(np.min(lat)) * 1e3, 2)
        if lengths is None:
            lengths = length_stats(ids)
    out.update(lengths)
    out["realistic_recipe"] = RECIPE_HASH
    if verbose:
        for k, v in out.items():
            _note(f"{k}: {v}")
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="sketchformer_tpu_torch.tools.bench_decode_realistic")
    p.add_argument("--json", action="store_true",
                   help="print one JSON line of the measurements only")
    args = p.parse_args(argv)
    cap = float(os.environ.get("SKETCHFORMER_REALISTIC_CAP_S", "900"))
    # the checks' lines and the notes go to stderr, the result to stdout
    with contextlib.redirect_stdout(sys.stderr):
        model, val = get_trained_flagship(max_seconds=cap)
        got = None if model is None else measure(model, val)
    if got is None:
        _note("training did not complete within cap; no measurement")
        return
    print(json.dumps(got), flush=True)


if __name__ == "__main__":
    sys.exit(main())
