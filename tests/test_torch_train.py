"""Continuous (MDN) training in the port against the JAX package, f32 on
the CPU: one train step (loss, every metric, grad norm, updated
parameters), a 5-step loss trajectory, microbatching, the optimizer, the
MDN loss, the packed-batch expansion; and the port's own guarantees: the
non-finite guard, checkpoint resume, the dropout keep rate, the train /
eval CLI.

The port runs ``attn_impl='pallas'`` (its kernel stacks, on the CPU their
plain versions); the JAX reference runs its composed flax path, which the
JAX package's own tests hold to its fused kernels."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sketchformer_tpu.data.packed import pack_batch as jax_pack
from sketchformer_tpu.data.packed import unpack_batch as jax_unpack
from sketchformer_tpu.data.registry import get_dataloader_by_name
from sketchformer_tpu.models import Sketchformer as JaxSketchformer
from sketchformer_tpu.models import SketchformerConfig as JaxConfig
from sketchformer_tpu.ops import mdn as jax_mdn
from sketchformer_tpu.train.schedule import make_optimizer
from sketchformer_tpu.train.step import (
    TrainState as JaxTrainState,
    create_train_state as jax_create_state,
    make_train_step as jax_make_train_step,
)
from sketchformer_tpu_torch import cli
from sketchformer_tpu_torch.config import SketchformerConfig
from sketchformer_tpu_torch.convert import params_from_flax, params_to_flax
from sketchformer_tpu_torch.data.packed import pack_batch, unpack_batch
from sketchformer_tpu_torch.models.dropout import dropout
from sketchformer_tpu_torch.models.sketchformer import Sketchformer
from sketchformer_tpu_torch.ops import mdn
from sketchformer_tpu_torch.train.checkpoint import CheckpointManager
from sketchformer_tpu_torch.train.schedule import NoamAdam, global_norm
from sketchformer_tpu_torch.train.step import (
    create_train_state,
    make_eval_step,
    make_train_step,
)

WARMUP, PEAK = 5, 2.0
CFG = dict(vocab_size=64, num_classes=5, max_len=24, d_model=32,
           num_layers=2, num_heads=2, dff=64, dropout=0.0, lowerdim=16,
           num_queries=2, use_continuous=True, num_mixtures=3,
           qk_norm=True, dtype="float32")
# Adam's first step moves each parameter by about the rate times
# g / (|g| + eps): where a gradient is zero up to rounding (every key bias,
# projection or k-norm, shifts a row's keys alike) the direction is noise.
# Such elements, |g| below NOISE times the largest of their leaf, and whole
# leaves that are such biases, are held only to move by at most twice the
# rate.
NOISE = 1e-4
ZERO_GRAD = ("key.bias", "k_norm.bias")


def _loader(seed=0):
    return get_dataloader_by_name("synthetic")(
        num_classes=5, sketches_per_epoch=64, batch_size=8, buckets=(24,),
        token_mode=False, seed=seed)


def _batches(n):
    it = _loader().batch_iterator("train")
    return [next(it) for _ in range(n)]


def _jax_setup(batch):
    model = JaxSketchformer(JaxConfig(**CFG, attn_impl="xla"))
    tx = make_optimizer(CFG["d_model"], warmup_steps=WARMUP, peak_scale=PEAK)
    state = jax_create_state(model, tx, jax.random.PRNGKey(0), batch)
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
            a.shape).astype(np.float32), state.params)
    state = JaxTrainState(params, tx.init(params), state.step, state.rng)
    return model, tx, state


def _port(params, **over):
    model = Sketchformer(SketchformerConfig(
        **{**CFG, "attn_impl": "pallas", **over}))
    model.load_state_dict(params_from_flax(params))
    return model


def _flat(tree):
    """A JAX param tree under the port's keys (``params_from_flax``)."""
    return {k: v.numpy() for k, v in params_from_flax(tree).items()}


def _grads(params, batch, accum=1):
    """The port's f32 gradients of the training loss at ``params``."""
    from sketchformer_tpu_torch.train.loss import cont_multitask_loss

    model = _port(params).train()
    full = unpack_batch({k: torch.from_numpy(np.asarray(v))
                         for k, v in pack_batch(batch).items()})
    n = full["enc"].shape[0] // accum
    for i in range(accum):
        part = {k: v[i * n:(i + 1) * n] for k, v in full.items()}
        out = model(enc=part["enc"], dec_in=part["dec_in"],
                    enc_mask=part["enc_mask"], dec_key_mask=part["dec_mask"])
        cont_multitask_loss(out, part, CFG["num_mixtures"])[0].backward()
    return {k: p.grad for k, p in model.named_parameters()}


def _check_params(model, params, grads, rate):
    ref = _flat(params)
    for name, p in model.named_parameters():
        g = grads[name].abs()
        firm = g > NOISE * g.max()
        if name.endswith(ZERO_GRAD):
            firm[:] = False
        got, want = p.detach().numpy(), ref[name]
        firm = firm.numpy()
        np.testing.assert_allclose(got[firm], want[firm], rtol=1e-4,
                                   atol=1e-5, err_msg=name)
        assert np.abs(got - want)[~firm].max(initial=0.0) <= 2 * rate, name


def test_train_step_matches_jax():
    """One step: loss rtol 1e-4, every metric and the grad norm rtol 1e-4
    (atol 1e-6), updated parameters rtol 1e-4 / atol 1e-5 (elements whose
    gradient is zero up to rounding within twice the step's rate)."""
    batch = _batches(1)[0]
    model, tx, state = _jax_setup(batch)
    port = _port(state.params)
    new_state, want = jax_make_train_step(model, tx)(state, jax_pack(batch))
    st = create_train_state(port, 0, WARMUP, PEAK)
    got = make_train_step(st)(pack_batch(batch))
    assert set(got) == set(want)
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                               rtol=1e-4)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    assert got["skipped_nonfinite"].item() == 0.0
    _check_params(port, new_state.params, _grads(state.params, batch),
                  _rate(1))


def _rate(count):
    step = max(count, 1)
    return PEAK * CFG["d_model"] ** -0.5 * min(step ** -0.5,
                                               step * WARMUP ** -1.5)


def test_five_step_loss_trajectory_matches_jax():
    """Five steps on five batches: losses within rtol 1e-3."""
    batches = _batches(5)
    model, tx, state = _jax_setup(batches[0])
    port = _port(state.params)
    jstep = jax_make_train_step(model, tx)
    st = create_train_state(port, 0, WARMUP, PEAK)
    pstep = make_train_step(st)
    want, got = [], []
    for b in batches:
        state, m = jstep(state, jax_pack(b))
        want.append(float(m["loss"]))
        got.append(pstep(pack_batch(b))["loss"].item())
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert st.step == 5 and int(st.opt.count) == 5


def test_accum_steps_matches_jax():
    """accum_steps=2 averages the two half-batches' gradients and metrics
    before one update, as the JAX step does; and its loss stays within
    the JAX test's 0.05 of the full-batch step's (the microbatch means of
    unequal mask counts differ slightly from the full-batch mean)."""
    batch = _batches(1)[0]
    model, tx, state = _jax_setup(batch)
    port = _port(state.params)
    new_state, want = jax_make_train_step(model, tx, accum_steps=2)(
        state, jax_pack(batch))
    got = make_train_step(create_train_state(port, 0, WARMUP, PEAK),
                          accum_steps=2)(pack_batch(batch))
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    _check_params(port, new_state.params,
                  _grads(state.params, batch, accum=2), _rate(1))
    full = _port(state.params)
    m = make_train_step(create_train_state(full, 0, WARMUP, PEAK))(
        pack_batch(batch))
    assert abs(m["loss"].item() - got["loss"].item()) < 0.05


def test_nonfinite_guard_keeps_params():
    batch = dict(_batches(1)[0])
    model, _, state = _jax_setup(batch)
    port = _port(state.params)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    st = create_train_state(port, 0, WARMUP, PEAK)
    enc = batch["enc"].copy()
    enc[0, 0, 0] = np.nan
    batch["enc"] = enc
    m = make_train_step(st)(pack_batch(batch))
    assert m["skipped_nonfinite"].item() == 1.0
    assert not np.isfinite(m["grad_norm"].item())
    for k, v in port.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert int(st.opt.count) == 0
    assert all(not m.any() for m in st.opt.mu)


def test_optimizer_matches_optax():
    """Clip + Adam + Noam against optax over 3 steps (one clipped), 1e-6."""
    rng = np.random.default_rng(0)
    ps = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,))]
    tx = make_optimizer(64, warmup_steps=2, peak_scale=2.0)
    jp = [jnp.asarray(p) for p in ps]
    st = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in ps]
    opt = NoamAdam(tp, 64, warmup_steps=2, peak_scale=2.0)
    for i in range(3):
        gs = [rng.standard_normal(p.shape).astype(np.float32)
              * (3.0 if i == 1 else 0.1) for p in ps]
        u, st = tx.update([jnp.asarray(g) for g in gs], st, jp)
        jp = optax.apply_updates(jp, u)
        tg = [torch.from_numpy(g) for g in gs]
        opt.step(tg, global_norm(tg))
        for a, b in zip(jp, tp):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=1e-6)


def _small_optimizer(seed=0):
    g = torch.Generator().manual_seed(seed)
    ps = [torch.randn(s, generator=g) for s in ((3, 4), (5,), (2, 3, 2))]
    return NoamAdam(ps, 64, warmup_steps=2, peak_scale=2.0), g


def _grads_of(opt, g, scale=1.0):
    return [torch.randn(p.shape, generator=g) * scale for p in opt.params]


def test_step_returns_a_device_flag_and_a_nonfinite_norm_changes_nothing():
    """step() answers with a 0-d f32 flag on the parameters' device (no
    host bool); a non-finite norm leaves the parameters, both moments and
    the count as they were, through the plain route."""
    opt, g = _small_optimizer()
    tg = _grads_of(opt, g)
    applied = opt.step(tg, global_norm(tg))
    assert isinstance(applied, torch.Tensor) and applied.dim() == 0
    assert applied.dtype == torch.float32 and applied.item() == 1.0
    before = [[t.clone() for t in ts] for ts in (opt.params, opt.mu, opt.nu)]
    for bad in (float("nan"), float("inf")):
        tg = _grads_of(opt, g)
        tg[1][0] = bad
        applied = opt.step(tg, global_norm(tg))
        assert applied.dim() == 0 and applied.item() == 0.0
        for ts, was in zip((opt.params, opt.mu, opt.nu), before):
            assert all(torch.equal(t, w) for t, w in zip(ts, was))
        assert opt.count == 1


def test_count_reads_as_an_int_and_takes_assignment():
    opt, g = _small_optimizer()
    assert opt.count == 0 and type(opt.count) is int
    tg = _grads_of(opt, g)
    opt.step(tg, global_norm(tg))
    opt.count += 1
    assert opt.count == 2 and type(opt.count) is int
    opt.count = 7
    assert opt.count == 7


def test_state_dict_round_trips_the_count_as_an_int(tmp_path):
    """After one applied and one skipped step the state holds count 1 (an
    int, through a checkpoint file too), and a fresh optimizer loaded from
    it continues exactly as the original."""
    opt, g = _small_optimizer()
    tg = _grads_of(opt, g, scale=3.0)
    opt.step(tg, global_norm(tg))
    tg = _grads_of(opt, g)
    tg[0][0, 0] = float("nan")
    opt.step(tg, global_norm(tg))
    torch.save(opt.state_dict(), tmp_path / "opt.pt")
    state = torch.load(tmp_path / "opt.pt")
    assert state["count"] == 1 and type(state["count"]) is int
    twin = NoamAdam([p.clone() for p in opt.params], 64, warmup_steps=2,
                    peak_scale=2.0)
    twin.load_state_dict(state)
    assert twin.count == 1 and type(twin.count) is int
    tg = _grads_of(opt, g)
    for o in (opt, twin):
        o.step(tg, global_norm(tg))
    for a, b in zip(opt.params + opt.mu + opt.nu,
                    twin.params + twin.mu + twin.nu):
        assert torch.equal(a, b)
    assert opt.count == twin.count == 2


def test_device_rate_equals_the_host_schedule():
    """The rate the update computes from the count on the device equals
    noam_schedule's on the host within 1 ulp, over counts 0-10,000."""
    from sketchformer_tpu_torch.ops.optimizer import rate_scalars
    from sketchformer_tpu_torch.train.schedule import noam_schedule

    hyper = NoamAdam([torch.zeros(3)], 64, warmup_steps=40,
                     peak_scale=2.0).hyper()
    sched = noam_schedule(64, 40, 2.0)
    got, want = [], []
    for c in range(10_001):
        lr, _, _ = rate_scalars(torch.tensor(c), hyper["b1"], hyper["b2"],
                                hyper["rate_scale"], hyper["rate_warm"])
        got.append(lr.item())
        want.append(sched(c))
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1


@pytest.mark.parametrize("big", [1e19, 1e20, 3e38])
def test_global_norm_overflows_where_optax_does(big):
    """A gradient element whose f32 square overflows (1e20, 3e38), here
    alone in its tensor, makes the norm inf as optax.global_norm's f32 sum
    of squares does, so the guard skips the step; at 1e19 the square is a
    finite f32, the norm agrees with optax and the step applies."""
    rng = np.random.default_rng(2)
    shapes = ((3, 4), (5,), (1,))
    gs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    gs[2][0] = big
    want = float(optax.global_norm([jnp.asarray(g) for g in gs]))
    tg = [torch.from_numpy(g) for g in gs]
    got = global_norm(tg)
    finite = big < 1.8e19
    assert np.isfinite(want) == finite
    if finite:
        np.testing.assert_allclose(got.item(), want, rtol=1e-6)
    else:
        assert got.item() == float("inf")
    opt = NoamAdam([torch.zeros(s) for s in shapes], 64, warmup_steps=2,
                   peak_scale=2.0)
    assert opt.step(tg, got).item() == float(finite)
    assert opt.count == int(finite)


def test_params_to_flax_inverts_params_from_flax():
    _, _, state = _jax_setup(_batches(1)[0])
    back = params_to_flax(params_from_flax(state.params))
    want = jax.tree_util.tree_leaves_with_path(state.params)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [jax.tree_util.keystr(k) for k, _ in got] == \
        [jax.tree_util.keystr(k) for k, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_mdn_loss_matches_jax():
    rng = np.random.default_rng(2)
    M = 4
    raw = (rng.standard_normal((3, 7, 6 * M + 3)) * 2).astype(np.float32)
    xy = rng.standard_normal((3, 7, 2)).astype(np.float32)
    pen = rng.integers(0, 3, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) > 0.3).astype(np.float32)
    want = jax_mdn.mdn_loss(jnp.asarray(raw), M, jnp.asarray(xy),
                            jnp.asarray(pen), jnp.asarray(mask))
    got = mdn.mdn_loss(torch.from_numpy(raw), M, torch.from_numpy(xy),
                       torch.from_numpy(pen), torch.from_numpy(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-5)


def test_unpack_matches_jax():
    batch = _batches(1)[0]
    want = jax_unpack(jax_pack(batch))
    got = unpack_batch({k: torch.from_numpy(np.asarray(v))
                        for k, v in pack_batch(batch).items()})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_checkpoint_resume_is_identical(tmp_path):
    batches = _batches(3)
    _, _, state = _jax_setup(batches[0])
    a = _port(state.params, dropout=0.1)
    st = create_train_state(a, 7, WARMUP, PEAK)
    step = make_train_step(st)
    for b in batches[:2]:
        step(pack_batch(b))
    mgr = CheckpointManager(str(tmp_path), save_interval_steps=1)
    assert mgr.save(st) and mgr.latest_step() == 2
    b_model = _port(state.params, dropout=0.1)
    sb = mgr.restore(create_train_state(b_model, 0, WARMUP, PEAK))
    assert sb.step == 2 and sb.seed == 7
    for (k, v), w in zip(a.state_dict().items(),
                         b_model.state_dict().values()):
        assert torch.equal(v, w), k
    ma = step(pack_batch(batches[2]))
    mb = make_train_step(sb)(pack_batch(batches[2]))
    assert ma["loss"].item() == mb["loss"].item()
    for v, w in zip(a.parameters(), b_model.parameters()):
        assert torch.equal(v, w)


def test_dropout_keep_rate():
    x = torch.ones(1 << 18)
    gen = torch.Generator().manual_seed(0)
    y = dropout(x, 0.1, generator=gen)
    thresh = round(0.1 * 256)
    keep = 1 - thresh / 256
    np.testing.assert_allclose((y != 0).float().mean().item(), keep,
                               atol=3e-3)
    np.testing.assert_allclose(y[y != 0][0].item(), 1 / keep, rtol=1e-6)
    assert torch.equal(dropout(x, 0.1, training=False), x)


def test_dropout_on_the_jax_draw_matches_jax(monkeypatch):
    """The JAX Dropout's own bytes, captured, give the port's dropout the
    JAX output exactly (bf16 and f32)."""
    import sketchformer_tpu.models.dropout as jax_dropout

    drawn = []
    real_bits = jax.random.bits

    def capture(*a, **k):
        drawn.append(real_bits(*a, **k))
        return drawn[-1]

    monkeypatch.setattr(jax_dropout.jax.random, "bits", capture)
    x = np.random.default_rng(3).standard_normal((4, 9, 16)).astype(
        np.float32)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = jax_dropout.Dropout(0.1).apply(
            {}, jnp.asarray(x, jdt), deterministic=False,
            rngs={"dropout": jax.random.PRNGKey(5)})
        got = dropout(torch.from_numpy(x).to(tdt), 0.1,
                      bits=torch.from_numpy(np.array(drawn[-1])))
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


def test_eval_mode_is_deterministic_and_training_mode_drops():
    batch = _batches(1)[0]
    _, _, state = _jax_setup(batch)
    port = _port(state.params, dropout=0.1)
    full = unpack_batch({k: torch.from_numpy(np.asarray(v))
                         for k, v in pack_batch(batch).items()})
    kw = dict(enc=full["enc"], dec_in=full["dec_in"],
              enc_mask=full["enc_mask"], dec_key_mask=full["dec_mask"])
    port.eval()
    with torch.no_grad():
        a = port(**kw)["recon"]
        b = _port(state.params)(**kw)["recon"]
        port.train()
        c = port(**kw)["recon"]
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_cli_train_then_eval(tmp_path, capsys):
    run = str(tmp_path / "run")
    common = ["--loader-arg", "batch_size=8", "--loader-arg",
              "buckets=[24]", "--loader-arg", "sketches_per_epoch=64",
              "--device", "cpu"]
    hp = ",".join(f"{k}={v}" for k, v in CFG.items()
                  if k not in ("use_continuous", "vocab_size",
                               "num_classes"))
    assert cli.main(["train", "--preset", "cont2cont_mdn", "--run-dir", run,
                     "--hparams", hp, *common, "--notifier", "none",
                     "--loop-arg", "total_steps=4", "--loop-arg",
                     "eval_every=2", "--loop-arg", "save_every=2",
                     "--loop-arg", "log_every=1", "--loop-arg",
                     "metrics=retrieval,embedding_stats,recon_grid"]) == 0
    final = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(final["val_loss"])
    mgr = CheckpointManager(run)
    assert mgr.all_steps() == [2, 4]
    assert mgr.load_config_dict()["attn_impl"] == "pallas"
    assert cli.main(["eval", "--run-dir", run, "--device", "cpu"]) == 0
    ev = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ev["loss"] == pytest.approx(final["val_loss"], rel=1e-3)
    with open(f"{run}/metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs[:2]] == [1, 2]
    assert any("retrieval_mAP" in r for r in recs)
    assert any("z_norm_mean" in r for r in recs)
    assert (tmp_path / "run" / "images" / "reconstruction_00000002.npy"
            ).exists()
