"""The serving subcommands of the port's CLI on a run dir its ``train``
wrote (``--run-dir``): ``embed``, ``sbir``, ``decode`` and ``interpolate``
restore the run's config, newest checkpoint and loader, and write what
``Sketchformer.embed`` and the port's decoders give on that checkpoint's
state. A token and a continuous (MDN) model, 2 steps each, on the CPU at a
tiny size."""

import numpy as np
import pytest
import torch

from sketchformer_tpu_torch import cli
from sketchformer_tpu_torch.config import SketchformerConfig
from sketchformer_tpu_torch.data.registry import get_dataloader_by_name
from sketchformer_tpu_torch.infer import decode as dec
from sketchformer_tpu_torch.infer.encode import interpolate
from sketchformer_tpu_torch.models.sketchformer import Sketchformer
from sketchformer_tpu_torch.train.checkpoint import CheckpointManager

HP = "num_layers=2,d_model=32,dff=64,lowerdim=16,max_len=24,num_heads=4"
DATA = ["--loader-arg", "batch_size=8", "--loader-arg", "buckets=[24]",
        "--loader-arg", "sketches_per_epoch=64", "--device", "cpu"]
PRESETS = ["tok2tok_cls_cpu", "cont2cont_mdn"]


@pytest.fixture(scope="module", params=PRESETS)
def run(request, tmp_path_factory):
    """(run dir trained for 2 steps, its model restored by hand, loader)."""
    path = str(tmp_path_factory.mktemp(request.param) / "run")
    hp = HP + (",num_mixtures=3" if request.param == "cont2cont_mdn" else "")
    assert cli.main(["train", "--preset", request.param, "--run-dir", path,
                     "--hparams", hp, *DATA, "--notifier", "none",
                     "--loop-arg", "total_steps=2", "--loop-arg",
                     "save_every=2", "--loop-arg", "eval_every=1000",
                     "--loop-arg", "warmup_steps=10"]) == 0
    ckpt = CheckpointManager(path)
    model = Sketchformer(SketchformerConfig(**ckpt.load_config_dict()))
    model.load_state_dict(ckpt.load_state_dict()["params"])
    meta = ckpt.load_meta()
    loader = get_dataloader_by_name(meta["loader"])(**meta["loader_kwargs"])
    return path, model.eval(), loader


def _serve(capsys, *argv):
    capsys.readouterr()
    assert cli.main([*argv, "--device", "cpu"]) == 0
    return capsys.readouterr().out


def _embed(model, batches):
    cont = model.config.use_continuous
    zs = []
    with torch.inference_mode():
        for b in batches:
            mask = torch.from_numpy(b["enc_mask"]) if cont else None
            z = model.embed(torch.from_numpy(b["enc"]), mask).numpy()
            zs.append(z[np.asarray(b["is_real"]) > 0.5])
    return np.concatenate(zs)


def _decode(model, loader, enc, mask, z=None):
    """The port's greedy decoders on the batch (or from ``z``), as the CLI
    writes them: concatenated stroke-3 points."""
    gen = torch.Generator().manual_seed(0)
    with torch.inference_mode():
        if model.config.use_continuous:
            xy, pen, valid = (dec.make_cont_decoder(model)(enc, mask, gen)
                              if z is None else
                              dec.make_cont_decoder_from_z(model)(z, gen))
            sk = dec.cont_to_sketches(xy.numpy(), pen.numpy(),
                                      valid.numpy(), scale=loader.scale)
        else:
            ids = (dec.make_token_decoder(model)(enc) if z is None else
                   dec.make_token_decoder_from_z(model)(z))
            sk = dec.tokens_to_sketches(loader.tokenizer, ids)
    return np.concatenate(sk, axis=0)


def test_serving_subcommands_read_the_run_dir(run, tmp_path, capsys):
    path, model, loader = run
    batches = loader.get_validation_set(max_batches=2)
    want_z = _embed(model, batches)

    out = str(tmp_path / "z.npz")
    _serve(capsys, "embed", "--run-dir", path, "--max-batches", "2",
           "--output", out)
    with np.load(out) as got:
        np.testing.assert_allclose(got["embeddings"], want_z, rtol=1e-5,
                                   atol=1e-6)

    out = str(tmp_path / "sbir.npz")
    _serve(capsys, "sbir", "--run-dir", path, "--max-batches", "2",
           "--output", out)
    with np.load(out) as got:
        np.testing.assert_allclose(got["embeddings"], want_z, rtol=1e-5,
                                   atol=1e-6)

    first = batches[0]
    enc = torch.from_numpy(first["enc"])
    mask = (torch.from_numpy(first["enc_mask"])
            if model.config.use_continuous else None)
    out = str(tmp_path / "dec.npz")
    _serve(capsys, "decode", "--run-dir", path, "--output", out)
    with np.load(out) as got:
        np.testing.assert_allclose(got["points"],
                                   _decode(model, loader, enc, mask),
                                   rtol=1e-5, atol=1e-6)

    out = str(tmp_path / "interp.npz")
    _serve(capsys, "interpolate", "--run-dir", path, "--steps", "3",
           "--index-b", "1", "--output", out)
    with torch.inference_mode():
        z = model.embed(enc, mask).numpy()
    want_path = interpolate(z[0], z[1], steps=3)
    with np.load(out) as got:
        np.testing.assert_allclose(got["embeddings"], want_path, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(
            got["points"],
            _decode(model, loader, None, None, torch.from_numpy(want_path)),
            rtol=1e-5, atol=1e-6)


def test_run_dir_excludes_weights_and_seed(capsys):
    parser = cli.build_parser()
    for sub in ("embed", "sbir", "decode", "interpolate"):
        for other in (["--weights", "w.npz"], ["--init-seed", "0"]):
            with pytest.raises(SystemExit):
                parser.parse_args([sub, "--run-dir", "r", *other])
        assert parser.parse_args([sub, "--run-dir", "r"]).run_dir == "r"
