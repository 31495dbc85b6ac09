"""Real multi-process data parallelism of the port on the CPU.

Two OS processes join one ``torch.distributed`` group over gloo
(``sketchformer_tpu_torch/parallel/multiprocess.py``), each streaming its
own shards, and must behave as one process on the global batch: the
counterparts of tests/test_multiprocess.py, plus the port's single-process
oracle held to the JAX package's (both starting from the JAX package's
initial parameters).
"""

import json
import os

import jax
import numpy as np
import pytest

from sketchformer_tpu.parallel import multiprocess as jmp
from sketchformer_tpu_torch.convert import params_from_flax, save_npz
from sketchformer_tpu_torch.parallel import multiprocess as mp

LAUNCH_TIMEOUT = 120.0   # seconds a worker may take; a hung rank fails


def jax_initial_weights(workdir: str) -> str:
    """The JAX harness's initial parameters (create_train_state at
    PRNGKey(0), as its reference_losses makes them) as a port npz."""
    from sketchformer_tpu.train.schedule import make_optimizer
    from sketchformer_tpu.train.step import create_train_state

    loader = jmp._loader(os.path.join(workdir, "data"), 0, 2)
    model = jmp._build_model(loader.num_classes, loader.vocab_size)
    first = next(iter(loader.batch_iterator("train")))
    state = create_train_state(
        model, make_optimizer(model.config.d_model), jax.random.PRNGKey(0),
        first)
    path = os.path.join(workdir, "jax_init.npz")
    save_npz(path, params_from_flax(jax.device_get(state.params)))
    return path


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("mp"))
    mp.write_scenario_dataset(os.path.join(workdir, "data"))
    init = jax_initial_weights(workdir)
    res = mp.launch(workdir, n_processes=2, timeout=LAUNCH_TIMEOUT,
                    init_weights=init)
    ref = mp.reference_losses(workdir, n_processes=2, init_weights=init)
    jax_ref = jmp.reference_losses(workdir, n_processes=2)
    return res, ref, jax_ref


def test_cluster_formed(results):
    res, _, _ = results
    assert [r["process_index"] for r in res] == [0, 1]
    for r in res:
        assert r["process_count"] == 2
        assert r["backend"] == "gloo"
        assert r["device"] == "cpu"


def test_streams_process_disjoint(results):
    """Shard striding: the two ranks train on different data but evaluate
    on the identical whole val split."""
    res, _, _ = results
    assert res[0]["train_stream_digest"] != res[1]["train_stream_digest"]
    assert res[0]["val_batch_digest"] == res[1]["val_batch_digest"]


def test_losses_agree_across_processes(results):
    """Both ranks observe the same global metrics and params bit for bit."""
    res, _, _ = results
    assert res[0]["losses"] == res[1]["losses"]
    assert res[0]["val_loss"] == res[1]["val_loss"]
    assert res[0]["params_digest"] == res[1]["params_digest"]


def test_loss_trajectory_matches_single_process(results):
    """The 2-rank run reproduces one process stepping over the
    concatenated rank streams."""
    res, ref, _ = results
    np.testing.assert_allclose(ref, res[0]["losses"], rtol=2e-4)


def test_reference_matches_jax_reference(results):
    """The port's single-process oracle equals the JAX package's on the
    same shards and initial parameters, and so does the 2-rank run."""
    res, ref, jax_ref = results
    np.testing.assert_allclose(ref, jax_ref, rtol=2e-4)
    np.testing.assert_allclose(res[0]["losses"], jax_ref, rtol=2e-4)


def test_checkpoint_written_once_and_restored_by_both(results):
    """Rank 0 writes ONE checkpoint; every rank restores it to the exact
    trained params."""
    res, _, _ = results
    assert [r["save_returned"] for r in res] == [True, False]
    for r in res:
        assert r["ckpt_steps"] == [4]
        assert r["restored_step"] == 4
        assert r["restored_equal"]


def test_production_train_loop_runs_multiprocess(tmp_path):
    """run_training itself across 2 ranks: reduced steps, checkpoint
    cadence, one writer (rank 0), eval identical on every rank. Metrics
    and params agree across ranks and the run dir holds one writer's
    records."""
    workdir = str(tmp_path)
    res = mp.launch(workdir, n_processes=2, timeout=LAUNCH_TIMEOUT,
                    scenario="loop")
    assert res[0]["final"] == res[1]["final"]
    assert res[0]["params_digest"] == res[1]["params_digest"]
    assert all(np.isfinite(v) for v in res[0]["final"].values())
    for r in res:
        assert r["metrics_jsonl_exists"] and r["config_exists"]
    run_dir = os.path.join(workdir, "run", "loop")
    assert sorted(os.listdir(os.path.join(run_dir, "checkpoints"))) == [
        "3", "6"]
    seen = set()
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            key = (rec["step"], tuple(sorted(k for k in rec
                                             if k not in ("time",))))
            assert key not in seen, f"duplicate metrics record {key}"
            seen.add(key)
    assert seen, "no metrics written at all"


def test_train_cli_run_dir_evaluates(tmp_path, capsys):
    """The train CLI's body by 2 ranks on the shard loader: rank 0 writes
    the run dir's config, loader meta and checkpoint, and ``cli eval
    --run-dir`` on it (no data flags) rebuilds the shard loader and gives
    the ranks' final eval metrics."""
    from sketchformer_tpu_torch import cli

    workdir = str(tmp_path)
    hp = ("d_model=32,num_layers=2,num_heads=4,dff=64,lowerdim=16,"
          "max_len=48,num_queries=2,dropout=0.0")
    res = mp.launch(workdir, n_processes=2, timeout=LAUNCH_TIMEOUT,
                    scenario="train", train_args=[
                        "--loader", "distributed_stroke3", "--hparams", hp,
                        "--loader-arg", "batch_size=8",
                        "--loader-arg", "buckets=[48]",
                        "--loader-arg", "grid_resolution=10",
                        "--loop-arg", "total_steps=2", "--loop-arg",
                        "eval_every=2", "--loop-arg", "save_every=2",
                        "--loop-arg", "warmup_steps=10", "--notifier", "none"])
    assert res[0]["final"] == res[1]["final"]
    assert res[0]["params_digest"] == res[1]["params_digest"]
    assert [r["ckpt_steps"] for r in res] == [[2], [2]]
    assert all(r["restored_equal"] for r in res)
    run_dir = os.path.join(workdir, "run")
    with open(os.path.join(run_dir, "run_meta.json")) as f:
        meta = json.load(f)
    assert meta["loader"] == "distributed_stroke3"
    assert meta["loader_kwargs"]["data_dir"] == os.path.join(workdir, "data")
    capsys.readouterr()
    assert cli.main(["eval", "--run-dir", run_dir, "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = {k[len("val_"):]: v for k, v in res[0]["final"].items()}
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=6e-5), k


def test_scenario_dataset_equals_jax(tmp_path):
    """The port's write_scenario_dataset writes what JAX's writes, array
    for array."""
    mp.write_scenario_dataset(str(tmp_path / "port"))
    jmp.write_scenario_dataset(str(tmp_path / "jax"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert sum(n.startswith("train_") for n in names) >= 4
    for name in names:
        with np.load(tmp_path / "jax" / name) as a, \
                np.load(tmp_path / "port" / name) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])


def test_world_of_one_equals_no_group(tmp_path):
    """A group of one rank takes the data-parallel path (the reductions
    and the scaled means) and still equals a run without a group, bit for
    bit."""
    workdir = str(tmp_path)
    res = mp.launch(workdir, n_processes=1, timeout=LAUNCH_TIMEOUT)
    assert res[0]["backend"] == "gloo" and res[0]["process_count"] == 1
    assert res[0]["losses"] == mp.reference_losses(workdir, n_processes=1)


def test_dropout_keys_fold_in_the_rank():
    """Ranks of a larger world draw different dropout bytes for the same
    (seed, step, microbatch); a world of one keeps the keys of a run
    without a group."""
    import torch

    from sketchformer_tpu_torch.models import dropout as drop
    from sketchformer_tpu_torch.train.step import dropout_context

    def draw(rank):
        with dropout_context(torch.device("cpu"), 3, 5, 0, rank):
            seed = drop.next_seed()
            bits = torch.randint(0, 256, (64,), dtype=torch.uint8,
                                 generator=drop.current_generator())
        return seed, bits

    s0, b0 = draw(0)
    s1, b1 = draw(1)
    assert s0 != s1 and not torch.equal(b0, b1)
    sn, bn = draw(None)
    with drop.use_generator(None, seed_key=(3, 5, 0)):
        assert drop.next_seed() == sn
    g = np.random.SeedSequence([3, 5, 0]).generate_state(1, np.uint64)[0]
    want = torch.randint(0, 256, (64,), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(int(g)))
    assert torch.equal(bn, want)
