"""The port's reference-weight importer against the JAX package's
``tools/import_reference_weights.py``: the same template letter for letter,
the same imported parameters for the same npz and mapping, a run dir that
``cli.restore_for_eval`` serves with the z and logits of the JAX model on
those parameters, the same rejections and the same flags.

The JAX side runs in one background process (``JAX_SIDE``): the JAX tool
as a script, as ``tests/test_tools.py`` runs it, for the template and the
import of each mode; then its run dir restored as ``test_tools.py``
restores it, and the JAX model's z and logits on that run dir's params."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from sketchformer_tpu_torch import cli
from sketchformer_tpu_torch.convert import init_params, params_from_flax
from sketchformer_tpu_torch.models.sketchformer import Sketchformer
from sketchformer_tpu_torch.tools import import_reference_weights as tool
from sketchformer_tpu_torch.train.checkpoint import CheckpointManager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOOL = os.path.join(REPO, "tools", "import_reference_weights.py")
TINY = ("d_model=32,num_layers=1,num_heads=2,dff=64,lowerdim=16,"
        "num_queries=2,max_len=32,vocab_size=68,num_classes=5,dropout=0.0")
MODES = {"tok": TINY, "cont": TINY + ",use_continuous=True,num_mixtures=3"}
REL = 1e-5

JAX_SIDE = """
import jax
jax.config.update("jax_platforms", "cpu")
import json, runpy, sys
import numpy as np

tool_path, jobs = sys.argv[1], json.loads(sys.argv[2])
for job in jobs:
    for argv in job["runs"]:
        sys.argv = ["tool"] + argv
        try:
            runpy.run_path(tool_path, run_name="__main__")
        except SystemExit as e:
            if e.code:
                raise

    from sketchformer_tpu.models import Sketchformer
    from sketchformer_tpu.train.checkpoint import CheckpointManager
    from sketchformer_tpu.train.schedule import make_optimizer
    from sketchformer_tpu.train.step import TrainState

    jtool = runpy.run_path(tool_path)
    model, cfg, params = jtool["_build_model"](job["hparams"])
    tx = make_optimizer(cfg.d_model)
    mgr = CheckpointManager(job["out"])
    restored = mgr.restore(TrainState(params, tx.init(params),
                                      np.zeros((), np.int32),
                                      jax.random.PRNGKey(0)))
    mgr.close()
    with np.load(job["inputs"]) as data:
        enc = data["enc"]
        mask = data["mask"] if "mask" in data.files else None
    p = {"params": restored.params}
    z = model.apply(p, enc, mask, method=Sketchformer.embed)
    logits = model.apply(p, z, method=lambda m, z: m.classifier(z))
    flat = jtool["_flatten"](jax.tree_util.tree_map(np.asarray,
                                                    restored.params))
    np.savez(job["result"], z=np.asarray(z), logits=np.asarray(logits),
             **{"params/" + k: v for k, v in flat.items()})
"""


def _reference(tmp_path, hparams, seed=7):
    """A made-up reference of the seeded state_dict: an npz of ``ref/<i>``
    names in a shuffled order, every 2-D leaf of unequal dims stored
    transposed, and the filled mapping. Returns (state_dict, npz, mapping)."""
    tmpl = str(tmp_path / "map.json")
    assert tool.main(["--hparams", hparams, "--dump-template", tmpl]) == 0
    with open(tmpl) as f:
        mapping = json.load(f)
    sd = init_params(tool.build_config(hparams), seed)
    order = np.random.default_rng(seed).permutation(len(mapping))
    weights = {}
    for i, path in zip(order, sorted(mapping)):
        arr = sd[path.replace("/", ".")].numpy()
        spec = mapping[path]
        spec["ref"] = f"ref/{i}"
        if arr.ndim == 2 and arr.shape[0] != arr.shape[1]:
            arr = arr.T
            spec["transpose"] = [1, 0]
        weights[spec["ref"]] = arr
    with open(tmpl, "w") as f:
        json.dump(mapping, f)
    wpath = str(tmp_path / "w.npz")
    np.savez(wpath, **weights)
    return sd, wpath, tmpl


def _inputs(cfg):
    rng = np.random.default_rng(3)
    if cfg.use_continuous:
        enc = rng.standard_normal((4, cfg.max_len, 3)).astype(np.float32)
        mask = np.ones((4, cfg.max_len), np.float32)
        mask[1, cfg.max_len // 2:] = 0.0
        return enc, mask
    enc = rng.integers(4, cfg.vocab_size, (4, cfg.max_len)).astype(np.int32)
    enc[1, cfg.max_len // 2:] = 0
    return enc, None


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """Per mode: the seeded state_dict, the npz and mapping of its made-up
    reference, and what the JAX process made of them (its template, its
    run dir, and the restored params, z and logits), that process started
    at once and waited for on first use."""
    refs, jobs = {}, []
    for mode in sorted(MODES):
        tmp = tmp_path_factory.mktemp(mode)
        sd, wpath, tmpl = _reference(tmp, MODES[mode])
        enc, mask = _inputs(tool.build_config(MODES[mode]))
        inputs = str(tmp / "inputs.npz")
        np.savez(inputs, enc=enc, **({} if mask is None else {"mask": mask}))
        ref = dict(sd=sd, weights=wpath, mapping=tmpl, enc=enc, mask=mask,
                   template=str(tmp / "jax_template.json"),
                   out=str(tmp / "jax_run"), result=str(tmp / "jax.npz"))
        refs[mode] = ref
        jobs.append(dict(
            hparams=MODES[mode], out=ref["out"], inputs=inputs,
            result=ref["result"],
            runs=[["--hparams", MODES[mode], "--dump-template",
                   ref["template"]],
                  ["--hparams", MODES[mode], "--weights", wpath,
                   "--mapping", tmpl, "--out", ref["out"]]]))
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + ":" + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = ""
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SIDE, JAX_TOOL, json.dumps(jobs)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    done = {}

    def get(mode):
        if not done:
            try:
                _, err = proc.communicate(timeout=300)
            finally:
                proc.kill()
            done.update(rc=proc.returncode, err=err)
        assert done["rc"] == 0, done["err"][-800:]
        return refs[mode]

    yield get
    proc.kill()
    proc.wait()


def _port_z_logits(model, enc, mask):
    with torch.no_grad():
        z = model.embed(torch.from_numpy(enc),
                        None if mask is None else torch.from_numpy(mask))
        return z.numpy(), model.classify(z).numpy()


def _restore_port(run_dir):
    args = cli.build_parser().parse_args(
        ["embed", "--run-dir", run_dir, "--device", "cpu",
         "--loader-arg", "num_classes=5", "--loader-arg", "batch_size=4",
         "--loader-arg", "sketches_per_epoch=16",
         "--loader-arg", "buckets=[32]"])
    model, _ = cli.restore_for_eval(args)
    return model


def _assert_rel(got, want):
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= REL, err


@pytest.mark.parametrize("mode", sorted(MODES))
def test_npz_import_serves_the_seeded_weights(mode, jax_side, tmp_path):
    sd, wpath, tmpl = _reference(tmp_path, MODES[mode])
    out = str(tmp_path / "run")
    assert tool.main(["--hparams", MODES[mode], "--weights", wpath,
                      "--mapping", tmpl, "--out", out]) == 0

    saved = CheckpointManager(out).load_state_dict()
    assert saved["step"] == 0 and saved["rng"] == 0
    assert saved["params"].keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(saved["params"][k], v), k
    opt = saved["opt_state"]
    assert opt["count"] == 0 and len(opt["mu"]) == len(sd)
    assert all(not m.any() for m in opt["mu"] + opt["nu"])

    model = _restore_port(out)
    cfg = model.config
    assert cfg == tool.build_config(MODES[mode])
    want = Sketchformer(cfg)
    want.load_state_dict(sd)
    enc, mask = _inputs(cfg)
    got_z, got_logits = _port_z_logits(model, enc, mask)
    want_z, want_logits = _port_z_logits(want.eval(), enc, mask)
    np.testing.assert_array_equal(got_z, want_z)
    np.testing.assert_array_equal(got_logits, want_logits)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_template_equals_jax_tools(mode, jax_side, tmp_path):
    ours = tmp_path / "ours.json"
    assert tool.main(["--hparams", MODES[mode], "--dump-template",
                      str(ours)]) == 0
    with open(jax_side(mode)["template"], "rb") as f:
        assert ours.read_bytes() == f.read()
    template = json.loads(ours.read_text())
    assert any(k.startswith("encoder/") for k in template)
    assert all(s["dtype"] == "float32" for s in template.values())


@pytest.mark.parametrize("mode", sorted(MODES))
def test_the_two_tools_import_the_same_weights(mode, jax_side, tmp_path):
    ref = jax_side(mode)
    ours = str(tmp_path / "ours")
    assert tool.main(["--hparams", MODES[mode], "--weights", ref["weights"],
                      "--mapping", ref["mapping"], "--out", ours]) == 0

    # the JAX tool's orbax run dir, restored, through params_from_flax
    tree: dict = {}
    with np.load(ref["result"]) as data:
        want_z, want_logits = data["z"], data["logits"]
        for key in data.files:
            if key.startswith("params/"):
                *path, leaf = key.split("/")[1:]
                node = tree
                for part in path:
                    node = node.setdefault(part, {})
                node[leaf] = data[key]
    jax_sd = params_from_flax(tree)
    port_sd = CheckpointManager(ours).load_state_dict()["params"]
    assert port_sd.keys() == jax_sd.keys()
    for k in jax_sd:
        assert torch.equal(port_sd[k], jax_sd[k]), k
        assert torch.equal(port_sd[k], ref["sd"][k]), k

    # the slice as a whole: the JAX model on its run dir's params and the
    # port's model from its run dir (plain versions on the CPU), f32
    got_z, got_logits = _port_z_logits(_restore_port(ours), ref["enc"],
                                       ref["mask"])
    _assert_rel(got_z, want_z)
    _assert_rel(got_logits, want_logits)


@pytest.mark.parametrize("fault", ["shape_mismatch", "unmapped"])
def test_import_rejects(fault, tmp_path, capsys):
    _, wpath, tmpl = _reference(tmp_path, TINY)
    with open(tmpl) as f:
        mapping = json.load(f)
    path = sorted(mapping)[0]
    if fault == "unmapped":
        mapping[path]["ref"] = ""
        want = f"UNMAPPED: {path}"
    else:
        weights = dict(np.load(wpath))
        ref = mapping[path]["ref"]
        weights[ref] = np.zeros([s + 1 for s in weights[ref].shape],
                                np.float32)
        np.savez(wpath, **weights)
        want = f"SHAPE MISMATCH: {path}"
    with open(tmpl, "w") as f:
        json.dump(mapping, f)
    capsys.readouterr()
    out = str(tmp_path / "o")
    assert tool.main(["--hparams", TINY, "--weights", wpath, "--mapping",
                      tmpl, "--out", out]) == 1
    assert want in capsys.readouterr().err
    assert not os.path.exists(os.path.join(out, "config.json"))


def _options(help_text):
    """The option strings of an argparse ``--help``: the words of its
    option lines that are flags."""
    return {w for line in help_text.splitlines()
            if line.lstrip().startswith("-")
            for w in re.split(r"[\s,]+", line)
            if re.fullmatch(r"--?[a-z][a-z-]*", w)}


def test_the_two_tools_take_the_same_flags(capsys):
    r = subprocess.run([sys.executable, JAX_TOOL, "--help"],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-800:]
    with pytest.raises(SystemExit) as e:
        tool.main(["--help"])
    assert e.value.code == 0
    ours = _options(capsys.readouterr().out)
    assert ours == _options(r.stdout)
    assert {"--hparams", "--dump-template", "--weights", "--tf-ckpt",
            "--mapping", "--out", "--help"} <= ours
