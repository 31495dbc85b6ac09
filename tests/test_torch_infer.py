"""The port's serving loop and CLI == the JAX package's, in float32."""

import dataclasses
import json

import jax
import numpy as np
import pytest

from sketchformer_tpu.data.registry import get_dataloader_by_name
from sketchformer_tpu.infer.encode import embed_dataset as jax_embed_dataset
from sketchformer_tpu.infer.sbir import retrieval_eval
from sketchformer_tpu.models import Sketchformer as JaxSketchformer
from sketchformer_tpu.models import SketchformerConfig as JaxConfig
from sketchformer_tpu_torch import cli
from sketchformer_tpu_torch.convert import params_from_flax, save_npz
from sketchformer_tpu_torch.infer.encode import (
    embed_dataset,
    interpolate,
    preprocess_on_device,
)
from torch_port_util import RTOL, ATOL, perturb, port_model

LOADER_ARGS = dict(num_classes=5, sketches_per_epoch=400, batch_size=12,
                   buckets=(64,))
HPARAMS = dict(d_model=32, num_layers=2, num_heads=4, dff=64, lowerdim=16,
               num_queries=2, max_len=64, dropout=0.0, num_classes=5,
               attn_impl="pallas")


def _setup(token_mode):
    loader = get_dataloader_by_name("synthetic")(token_mode=token_mode,
                                                 **LOADER_ARGS)
    batches = loader.get_validation_set(max_batches=8)
    # 50 validation sketches in batches of 12: the last batch is padded
    assert batches[-1]["is_real"].sum() < len(batches[-1]["is_real"])
    cfg = JaxConfig(vocab_size=loader.vocab_size,
                    use_continuous=not token_mode, **HPARAMS)
    model = JaxSketchformer(cfg)
    first = batches[0]
    params = model.init(jax.random.PRNGKey(0), first["enc"],
                        first["dec_in"])["params"]
    return model, perturb(params, 5), batches


@pytest.mark.parametrize("token_mode", [True, False], ids=["tok", "cont"])
def test_embed_dataset_matches_jax(token_mode):
    model, params, batches = _setup(token_mode)
    want_z, want_labels = jax_embed_dataset(model, params, batches)
    got_z, got_labels = embed_dataset(port_model(model, params), batches)
    n_real = int(sum(b["is_real"].sum() for b in batches))
    assert got_z.shape == (n_real, HPARAMS["lowerdim"])
    np.testing.assert_array_equal(got_labels, want_labels)
    np.testing.assert_allclose(got_z, np.asarray(want_z, np.float32),
                               rtol=RTOL, atol=ATOL)


def test_cli_sbir_and_embed_from_converted_npz(tmp_path, capsys):
    model, params, batches = _setup(True)
    want_z, want_labels = jax_embed_dataset(model, params, batches)
    state = params_from_flax(params)
    assert {k.split(".")[0] for k in state} == {
        "enc_embed", "encoder", "bottleneck", "classifier", "dec_embed",
        "decoder", "out_head"}
    weights = str(tmp_path / "weights.npz")
    save_npz(weights, state)

    common = ["--loader", "synthetic", "--device", "cpu",
              "--weights", weights, "--max-batches", "8",
              "--hparams", ",".join(f"{k}={v}" for k, v in HPARAMS.items())]
    for k, v in LOADER_ARGS.items():
        val = json.dumps(list(v)) if isinstance(v, tuple) else v
        common += ["--loader-arg", f"{k}={val}"]

    out = str(tmp_path / "z.npz")
    assert cli.main(["sbir", *common, "--output", out]) == 0
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    half = len(want_z) // 2
    want_metrics = retrieval_eval(
        np.asarray(want_z[:half], np.float64), want_labels[:half],
        np.asarray(want_z[half:], np.float64), want_labels[half:])
    assert metrics["protocol"] == "disjoint"
    assert metrics["gallery_size"] == len(want_z) - half
    for k, v in want_metrics.items():
        assert metrics[k] == pytest.approx(round(v, 4), abs=1e-4)
    with np.load(out) as data:
        np.testing.assert_allclose(data["embeddings"], want_z,
                                   rtol=RTOL, atol=ATOL)

    emb = str(tmp_path / "emb.npz")
    assert cli.main(["embed", *common, "--output", emb]) == 0
    assert json.loads(capsys.readouterr().out)["embeddings"] == \
        [len(want_z), HPARAMS["lowerdim"]]
    with np.load(emb) as data:
        np.testing.assert_array_equal(data["labels"], want_labels)


def test_cli_requires_a_weight_source():
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["embed", "--preset", "sbir"])


def test_interpolate_and_preprocess_match_jax():
    import jax.numpy as jnp
    import torch

    from sketchformer_tpu.infer import encode as jax_encode

    rng = np.random.default_rng(0)
    za, zb = rng.standard_normal((2, 16)).astype(np.float32)
    np.testing.assert_array_equal(interpolate(za, zb, 5),
                                  jax_encode.interpolate(za, zb, 5))
    raw = rng.standard_normal((3, 10, 3)).astype(np.float32)
    want = jax_encode.preprocess_on_device(jnp.asarray(raw), 2.5)
    got = preprocess_on_device(torch.from_numpy(raw), 2.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_port_model_config_matches():
    model, params, _ = _setup(True)
    port = port_model(model, params)
    assert dataclasses.asdict(port.config) == dataclasses.asdict(model.config)
