"""The port's remaining public names against the JAX package's: the model
registry, the Noam schedule and optimizer, ``supports_fast_decode``, the
null metric writer, the train loop's profiler window, the console script
and the example; and a walk of both packages that fails when a public
top-level name of the JAX package has no counterpart in the port."""

import importlib
import importlib.util
import inspect
import json
import pathlib
import tomllib

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sketchformer_tpu.infer.fast_decode import (
    supports_fast_decode as jax_supports_fast_decode,
)
from sketchformer_tpu.models import Sketchformer as JaxSketchformer
from sketchformer_tpu.models import SketchformerConfig as JaxConfig
from sketchformer_tpu.train import schedule as jax_schedule
from sketchformer_tpu_torch.data.registry import get_dataloader_by_name
from sketchformer_tpu_torch.examples import basic_usage
from sketchformer_tpu_torch.infer.fast_decode import supports_fast_decode
from sketchformer_tpu_torch.models import (
    Sketchformer,
    SketchformerConfig,
    get_model_by_name,
    models,
)
from sketchformer_tpu_torch.train import schedule
from sketchformer_tpu_torch.train.loop import TrainLoopConfig, run_training
from sketchformer_tpu_torch.utils.metrics import MetricWriter, NullMetricWriter

ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = dict(vocab_size=64, num_classes=5, max_len=24, d_model=32,
            num_layers=1, num_heads=4, dff=64, lowerdim=16, num_queries=2)


def test_registry_builders():
    assert sorted(models.names()) == ["sketchformer", "sketchformer-cont"]
    m = get_model_by_name("sketchformer")(**TINY)
    assert isinstance(m, Sketchformer)
    assert not m.config.use_continuous
    m2 = get_model_by_name("sketchformer-cont")(**TINY)
    assert m2.config.use_continuous
    m3 = get_model_by_name("sketchformer-cont")(use_continuous=False, **TINY)
    assert not m3.config.use_continuous
    with pytest.raises(KeyError, match="registered"):
        get_model_by_name("sketchformer-xl")


WARMUP = 40


@pytest.mark.parametrize("step", [0, 1, WARMUP, 10 * WARMUP])
def test_noam_schedule_equals_jax(step):
    got = schedule.noam_schedule(128, WARMUP, 2.5)(step)
    want = float(jax_schedule.noam_schedule(128, WARMUP, 2.5)(
        jnp.asarray(step, jnp.int32)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_optimizer_rate_is_the_schedule():
    opt = schedule.make_optimizer([torch.zeros(3)], 64, warmup_steps=10,
                                  peak_scale=3.0)
    sched = schedule.noam_schedule(64, 10, 3.0)
    assert [opt.rate(c) for c in range(25)] == [sched(c) for c in range(25)]


@pytest.mark.parametrize("grad_scale", [0.01, 10.0],
                         ids=["unclipped", "clipped"])
def test_make_optimizer_updates_equal_optax(grad_scale):
    """The first updates of make_optimizer (JAX's defaults, Noam warmup)
    equal optax's chain on the same parameters and gradients."""
    rng = np.random.default_rng(0)
    shapes = {"w": (6, 5), "b": (5,)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    grads = [{k: (grad_scale * rng.standard_normal(s)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(4)]
    tx = jax_schedule.make_optimizer(32, warmup_steps=3, peak_scale=2.0)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = tx.init(jp)
    tp = [torch.from_numpy(p0[k].copy()) for k in shapes]
    opt = schedule.make_optimizer(tp, 32, warmup_steps=3, peak_scale=2.0)
    for g in grads:
        upd, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tg = [torch.from_numpy(g[k]) for k in shapes]
        assert opt.step(tg, schedule.global_norm(tg))
        for k, t in zip(shapes, tp):
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("over,supported", [
    ({}, True),
    ({"use_continuous": True, "num_mixtures": 3}, False),
    ({"norm_first": False}, False),
], ids=["token", "mdn", "post_ln"])
def test_supports_fast_decode(over, supported):
    kw = dict(TINY, **over)
    assert supports_fast_decode(Sketchformer(SketchformerConfig(**kw))) \
        is supported
    assert jax_supports_fast_decode(JaxSketchformer(JaxConfig(**kw))) \
        is supported


def test_null_metric_writer_writes_nothing(tmp_path):
    w = NullMetricWriter()
    w.write_scalars(1, {"loss": 1.0})
    w.write_image(1, "grid", np.zeros((4, 4), np.float32))
    w.close()
    assert list(tmp_path.iterdir()) == []


def test_metric_writer_writes_jsonl_and_npy_only(tmp_path):
    w = MetricWriter(str(tmp_path))
    w.write_scalars(3, {"loss": 1.5})
    w.write_image(3, "grid", np.ones((4, 4), np.float32))
    w.close()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["images",
                                                          "metrics.jsonl"]
    rec = json.loads((tmp_path / "metrics.jsonl").read_text())
    assert rec["step"] == 3 and rec["loss"] == 1.5
    np.testing.assert_array_equal(
        np.load(tmp_path / "images" / "grid_00000003.npy"), np.ones((4, 4)))


def _tiny_loader():
    return get_dataloader_by_name("synthetic")(
        num_classes=4, sketches_per_epoch=64, batch_size=4, buckets=(24,))


@pytest.mark.parametrize("profile_steps", [0, 2])
def test_profile_steps_leaves_a_trace(profile_steps, tmp_path):
    """profile_steps=N traces steps [start + 10, start + 10 + N) into
    run_dir/profile, with the program's spans of each step and of its wait
    for a batch; 0 traces nothing."""
    loader = _tiny_loader()
    model = Sketchformer(SketchformerConfig(
        **dict(TINY, vocab_size=loader.vocab_size, num_classes=4,
               dropout=0.0)))
    run_dir = str(tmp_path / "run")
    run_training(model, loader, run_dir, TrainLoopConfig(
        total_steps=13, eval_every=1000, save_every=1000, log_every=1000,
        warmup_steps=5, profile_steps=profile_steps))
    prof = tmp_path / "run" / "profile"
    if not profile_steps:
        assert not prof.exists()
        return
    traces = sorted(prof.glob("*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("backward" in str(e.get("name", "")).lower() for e in events)
    names = [str(e.get("name", "")) for e in events]
    for span in ("sk.train.step", "sk.train.data_wait"):
        assert names.count(span) == profile_steps
    assert "sk.train.guard" in names and "sk.train.update" in names


def test_console_script():
    with open(ROOT / "pyproject.toml", "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    assert scripts["sketchformer-tpu"] == "sketchformer_tpu.cli:main"
    assert scripts["sketchformer-torch"] == "sketchformer_tpu_torch.cli:main"
    mod, fn = scripts["sketchformer-torch"].split(":")
    main = getattr(importlib.import_module(mod), fn)
    with pytest.raises(SystemExit) as e:
        main(["--help"])
    assert e.value.code == 0


def test_counted_modules_are_every_kernel_module():
    """ops.counted_modules() lists every ops module that counts kernel
    launches, so one reset and one read cover every kernel."""
    from sketchformer_tpu_torch import ops

    with_counts = set()
    for path in sorted((ROOT / "sketchformer_tpu_torch" / "ops").glob("*.py")):
        mod = importlib.import_module(f"sketchformer_tpu_torch.ops.{path.stem}")
        if hasattr(mod, "LAUNCHES"):
            with_counts.add(mod.__name__)
    assert {m.__name__ for m in ops.counted_modules()} == with_counts
    ops.reset_launches()
    counts = ops.launch_counts()
    assert counts and set(counts.values()) == {0}


def test_example_runs_on_the_cpu(tmp_path, capsys):
    out = basic_usage.main([
        "--device", "cpu", "--run-dir", str(tmp_path / "ex"), "--steps", "2",
        "--d-model", "32", "--max-len", "32", "--batch-size", "8"])
    assert out["embeddings"][1] == 16
    assert out["reconstructions"] == 8 and out["interpolation"] == 5
    assert all(np.isfinite(v) for k, v in out.items()
               if k.startswith("val_"))
    assert (tmp_path / "ex" / "checkpoints" / "2").is_dir()
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == \
        json.loads(json.dumps(out))


# --- the walk ---------------------------------------------------------------

# modules of the JAX package that are not ported (ROADMAP.md "Not to port"):
# TPU device meshes and GSPMD sharding, the persistent XLA cache, and the
# device-prefetch thread that answered a remote TPU's blocking device_put
NOT_TO_PORT = ("sketchformer_tpu.parallel.mesh",
               "sketchformer_tpu.parallel.sharding",
               "sketchformer_tpu.utils.compile_cache",
               "sketchformer_tpu.data.prefetch")
# documented renames: the port's key masks are (B, T), not (B, 1, 1, T)
RENAMES = {("sketchformer_tpu.models.attention", "padding_mask_from_ids"):
           "key_mask_from_ids",
           ("sketchformer_tpu.models.attention", "padding_mask_from_float"):
           "key_mask_from_float"}
NOT_YET = set()


def _jax_modules():
    pkg = ROOT / "sketchformer_tpu"
    out = []
    for path in sorted(pkg.rglob("*.py")):
        parts = path.relative_to(ROOT).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        name = ".".join(parts)
        if ".ops.pallas_" in name or name in NOT_TO_PORT:
            continue
        out.append(name)
    return out


def _public_names(mod):
    """Functions and classes a module defines, and for a package those it
    re-exports from the package's own modules (not from a module that is
    not ported)."""
    is_pkg = hasattr(mod, "__path__")
    for k, v in vars(mod).items():
        if k.startswith("_") or not (inspect.isfunction(v)
                                     or inspect.isclass(v)):
            continue
        origin = getattr(v, "__module__", "")
        if origin == mod.__name__ or (
                is_pkg and origin.startswith("sketchformer_tpu.")
                and origin not in NOT_TO_PORT):
            yield k


@pytest.mark.parametrize("name", _jax_modules())
def test_every_public_name_has_a_counterpart(name):
    jmod = importlib.import_module(name)
    port = importlib.import_module(
        "sketchformer_tpu_torch" + name[len("sketchformer_tpu"):])
    missing = []
    for k in _public_names(jmod):
        if (name, k) in NOT_YET:
            continue
        want = RENAMES.get((name, k), k)
        if not hasattr(port, want):
            missing.append(want)
    assert not missing, f"{port.__name__} lacks {missing}"


def test_the_importer_has_the_jax_tools_public_names():
    """The repo-root ``tools/import_reference_weights.py`` (the JAX side's
    script, outside the package walk) against the port's tool."""
    spec = importlib.util.spec_from_file_location(
        "jax_import_tool", ROOT / "tools" / "import_reference_weights.py")
    jtool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtool)
    port = importlib.import_module(
        "sketchformer_tpu_torch.tools.import_reference_weights")
    names = [k for k, v in vars(jtool).items()
             if not k.startswith("_") and inspect.isfunction(v)
             and v.__module__ == jtool.__name__]
    assert names == ["main"]
    assert all(inspect.isfunction(getattr(port, k, None)) for k in names)


@pytest.mark.parametrize("name", ["bench_embed_pipeline",
                                  "bench_decode_realistic"])
def test_the_bench_tools_have_the_jax_tools_public_names(name):
    """The repo-root benchmark tools (outside the package walk) against
    the port's tools of the same names."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", ROOT / "tools" / f"{name}.py")
    jtool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtool)
    port = importlib.import_module(f"sketchformer_tpu_torch.tools.{name}")
    names = [k for k, v in vars(jtool).items()
             if not k.startswith("_") and inspect.isfunction(v)
             and v.__module__ == jtool.__name__]
    assert "measure" in names and "main" in names
    assert all(inspect.isfunction(getattr(port, k, None)) for k in names)


def test_the_walk_sees_every_package():
    names = _jax_modules()
    for pkg in ("cli", "parallel.multiprocess", "models.registry",
                "train.schedule", "utils.metrics", "infer.fast_decode"):
        assert f"sketchformer_tpu.{pkg}" in names
    assert not any(".pallas_" in n or n in NOT_TO_PORT for n in names)
