"""Token-mode training in the port against the JAX package, f32 on the CPU,
dropout 0: the token batch expansion, ``forward_tok_loss`` (both CE impls),
the token loss assembly (full logits and fused), one train step (loss, every metric, grad norm, updated parameters), a
5-step loss trajectory, microbatching, the eval step, and the train / eval
CLI on the ``tok2tok_cls_cpu`` preset at a tiny size.

The port runs ``attn_impl='pallas'`` (its kernel stacks and the K6 CE head;
on the CPU their plain versions); the JAX reference runs its composed flax
path and the chunked CE, which the JAX package's own tests hold to its
kernels. Tolerances are those of tests/test_torch_train.py."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketchformer_tpu.data.packed import pack_batch as jax_pack
from sketchformer_tpu.data.packed import unpack_batch as jax_unpack
from sketchformer_tpu.data.registry import get_dataloader_by_name
from sketchformer_tpu.data.tokenizer import GridTokenizer
from sketchformer_tpu.models import Sketchformer as JaxSketchformer
from sketchformer_tpu.models import SketchformerConfig as JaxConfig
from sketchformer_tpu.train.loss import tok_multitask_loss as jax_tok_loss
from sketchformer_tpu.train.schedule import make_optimizer
from sketchformer_tpu.train.step import (
    TrainState as JaxTrainState,
    create_train_state as jax_create_state,
    make_eval_step as jax_make_eval_step,
    make_train_step as jax_make_train_step,
)
from sketchformer_tpu_torch import cli
from sketchformer_tpu_torch.config import SketchformerConfig
from sketchformer_tpu_torch.convert import params_from_flax
from sketchformer_tpu_torch.data.packed import pack_batch, unpack_batch
from sketchformer_tpu_torch.models.sketchformer import Sketchformer
from sketchformer_tpu_torch.train.checkpoint import CheckpointManager
from sketchformer_tpu_torch.train.loss import (
    tok_multitask_loss,
    tok_multitask_loss_fused,
)
from sketchformer_tpu_torch.train.step import (
    create_train_state,
    make_eval_step,
    make_train_step,
)

WARMUP, PEAK = 5, 2.0
RESOLUTION = 6                     # a 40-token vocab
CFG = dict(vocab_size=RESOLUTION ** 2 + 4, num_classes=5, max_len=24,
           d_model=32, num_layers=2, num_heads=2, dff=64, dropout=0.0,
           lowerdim=16, num_queries=2, qk_norm=True, dtype="float32")
# as tests/test_torch_train.py: elements whose gradient is zero up to
# rounding (every key bias shifts a row's keys alike) move by at most twice
# the step's rate
NOISE = 1e-4
ZERO_GRAD = ("key.bias", "k_norm.bias")


def _batches(n):
    loader = get_dataloader_by_name("synthetic")(
        num_classes=5, sketches_per_epoch=64, batch_size=8, buckets=(24,),
        token_mode=True, tokenizer=GridTokenizer(RESOLUTION), seed=0)
    assert loader.vocab_size == CFG["vocab_size"]
    it = loader.batch_iterator("train")
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


def _full(batch):
    return unpack_batch({k: torch.from_numpy(np.asarray(v))
                         for k, v in pack_batch(batch).items()})


def _grads(params, batch, accum=1):
    """The port's f32 gradients of the training loss at ``params``."""
    model = _port(params).train()
    full = _full(batch)
    n = full["enc"].shape[0] // accum
    for i in range(accum):
        part = {k: v[i * n:(i + 1) * n] for k, v in full.items()}
        out = model.forward_tok_loss(part["enc"], part["dec_in"],
                                     part["dec_tgt"],
                                     row_weights=part.get("is_real"))
        tok_multitask_loss_fused(out, part)[0].backward()
    return {k: p.grad for k, p in model.named_parameters()}


def _rate(count):
    step = max(count, 1)
    return PEAK * CFG["d_model"] ** -0.5 * min(step ** -0.5,
                                               step * WARMUP ** -1.5)


def _check_params(model, params, grads, rate):
    ref = {k: v.numpy() for k, v in params_from_flax(params).items()}
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


def test_token_unpack_matches_jax():
    batch = _batches(1)[0]
    want = jax_unpack(jax_pack(batch))
    got = _full(batch)
    assert set(got) == set(want) >= {"dec_in", "dec_tgt", "is_real"}
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


@pytest.mark.parametrize("attn_impl", ["pallas", "xla"])
def test_forward_tok_loss_matches_jax(attn_impl):
    """recon_loss / recon_acc / cls / embedding (rtol 1e-4, atol 1e-6) of
    the port's two CE impls against the JAX model's, with row weights."""
    batch = _batches(1)[0]
    model, _, state = _jax_setup(batch)
    full = jax_unpack(jax_pack(batch))
    rw = np.ones(8, np.float32)
    rw[3] = 0.0
    want = model.apply({"params": state.params}, full["enc"],
                       full["dec_in"], full["dec_tgt"], deterministic=True,
                       row_weights=jnp.asarray(rw),
                       method=JaxSketchformer.forward_tok_loss)
    port = _port(state.params, attn_impl=attn_impl).train()
    tb = _full(batch)
    with torch.no_grad():
        got = port.forward_tok_loss(tb["enc"], tb["dec_in"], tb["dec_tgt"],
                                    row_weights=torch.from_numpy(rw))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_tok_multitask_loss_matches_jax_and_fused():
    """``tok_multitask_loss`` on the full logits of the teacher-forced
    forward against JAX's on its logits, and against the fused assembly of
    ``forward_tok_loss``: every metric rtol 1e-4, atol 1e-6."""
    batch = _batches(1)[0]
    model, _, state = _jax_setup(batch)
    full = jax_unpack(jax_pack(batch))
    outs = model.apply({"params": state.params}, full["enc"], full["dec_in"],
                       deterministic=True)
    _, want = jax_tok_loss(outs, full)
    port = _port(state.params).eval()
    tb = _full(batch)
    with torch.no_grad():
        _, got = tok_multitask_loss(port(tb["enc"], tb["dec_in"]), tb)
        _, fused = tok_multitask_loss_fused(port.forward_tok_loss(
            tb["enc"], tb["dec_in"], tb["dec_tgt"],
            row_weights=tb["is_real"]), tb)
    assert set(got) == set(want) == set(fused)
    for k in want:
        for have in (got, fused):
            np.testing.assert_allclose(have[k].item(), float(want[k]),
                                       rtol=1e-4, atol=1e-6, err_msg=k)


def test_token_train_step_matches_jax():
    """One step: every metric and the grad norm rtol 1e-4 (atol 1e-6),
    updated parameters rtol 1e-4 / atol 1e-5 (elements whose gradient is
    zero up to rounding within twice the step's rate)."""
    batch = _batches(1)[0]
    model, tx, state = _jax_setup(batch)
    port = _port(state.params)
    new_state, want = jax_make_train_step(model, tx)(state, jax_pack(batch))
    got = make_train_step(create_train_state(port, 0, WARMUP, PEAK))(
        pack_batch(batch))
    assert set(got) == set(want)
    assert {"recon_acc", "cls_acc", "grad_norm"} <= set(got)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    _check_params(port, new_state.params, _grads(state.params, batch),
                  _rate(1))


def test_token_five_step_loss_trajectory_matches_jax():
    """Five steps on five batches: losses within rtol 1e-3."""
    batches = _batches(5)
    model, tx, state = _jax_setup(batches[0])
    jstep = jax_make_train_step(model, tx)
    st = create_train_state(_port(state.params), 0, WARMUP, PEAK)
    pstep = make_train_step(st)
    want, got = [], []
    for b in batches:
        state, m = jstep(state, jax_pack(b))
        want.append(float(m["loss"]))
        got.append(pstep(pack_batch(b))["loss"].item())
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert st.step == 5


def test_token_accum_steps_matches_jax():
    """accum_steps=2: the two half-batches' gradients and metrics averaged
    before one update, as the JAX step does."""
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


def test_token_eval_step_matches_jax():
    """The eval step (the inference stacks, the CE kernel's plain version)
    against the JAX eval step: every metric rtol 1e-4, atol 1e-6."""
    batch = _batches(1)[0]
    model, _, state = _jax_setup(batch)
    want = jax_make_eval_step(model)(state.params, jax_pack(batch))
    got = make_eval_step(_port(state.params))(pack_batch(batch))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_token_cli_train_then_eval(tmp_path, capsys):
    """The tok2tok_cls_cpu preset through the port's CLI at a tiny size,
    with the kernel path (attn_impl=pallas) and dropout on: finite
    metrics, checkpoints, and eval of the checkpoint equal to the run's
    final eval."""
    run = str(tmp_path / "run")
    common = ["--loader-arg", "batch_size=8", "--loader-arg",
              "buckets=[24]", "--loader-arg", "sketches_per_epoch=64",
              "--device", "cpu"]
    hp = ("num_layers=2,d_model=32,dff=64,lowerdim=16,max_len=24,"
          "num_heads=4,attn_impl=pallas")
    assert cli.main(["train", "--preset", "tok2tok_cls_cpu", "--run-dir",
                     run, "--hparams", hp, *common, "--notifier", "none",
                     "--loop-arg", "total_steps=4", "--loop-arg",
                     "eval_every=2", "--loop-arg", "save_every=2",
                     "--loop-arg", "log_every=1", "--loop-arg",
                     "warmup_steps=10"]) == 0
    final = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"val_loss", "val_recon_acc", "val_cls_acc"} <= set(final)
    assert all(np.isfinite(v) for v in final.values())
    mgr = CheckpointManager(run)
    assert mgr.all_steps() == [2, 4]
    saved = mgr.load_config_dict()
    assert not saved["use_continuous"] and saved["vocab_size"] == 10004
    assert cli.main(["eval", "--run-dir", run, "--device", "cpu"]) == 0
    ev = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ev["loss"] == pytest.approx(final["val_loss"], rel=1e-3)
    with open(f"{run}/metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs[:2]] == [1, 2]
    assert all("recon_acc" in r for r in recs if "loss" in r)
