"""The post-LN model (``norm_first=False``, the reference Sketchformer's
layer order) with ``attn_impl='pallas'`` in the port against the JAX
package, float32 on the CPU, on the same seeded inputs and converted
weights: embeddings and class logits, one train step (loss, every metric,
the grad norm, the updated parameters), the eval step and greedy decodes,
token and continuous; and the train / eval CLI with ``--hparams
norm_first=False``.

The fused stacks decline the post-LN model (engine note "post-LN config")
in both packages, so the composed layers run, and their self-attention is
K8: the JAX ``flash_attention`` (Pallas, interpret mode here) and the
port's ``ops/flash_attention.py`` (its plain versions on CPU tensors)."""

import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketchformer_tpu.data.packed import pack_batch as jax_pack
from sketchformer_tpu.data.registry import get_dataloader_by_name
from sketchformer_tpu.data.tokenizer import GridTokenizer
from sketchformer_tpu.infer import decode as jdec
from sketchformer_tpu.models import Sketchformer as JaxSketchformer
from sketchformer_tpu.models import SketchformerConfig as JaxConfig
from sketchformer_tpu.train.schedule import make_optimizer
from sketchformer_tpu.train.step import (
    TrainState as JaxTrainState,
    create_train_state as jax_create_state,
    make_eval_step as jax_make_eval_step,
    make_train_step as jax_make_train_step,
)
from sketchformer_tpu_torch import cli
from sketchformer_tpu_torch.convert import params_from_flax, params_to_flax
from sketchformer_tpu_torch.data.packed import pack_batch
from sketchformer_tpu_torch.infer import decode as tdec
from sketchformer_tpu_torch.ops import flash_attention as fa
from sketchformer_tpu_torch.train.step import (
    create_train_state,
    make_eval_step,
    make_train_step,
)
from sketchformer_tpu_torch.utils.engines import reset_seen
from torch_port_util import cont_batch, port_model, token_batch

WARMUP, PEAK = 5, 2.0
RESOLUTION = 6                     # the token loader's 40-token vocab
POST_LN = dict(num_classes=5, max_len=24, d_model=64, num_layers=2,
               num_heads=4, dff=128, dropout=0.0, lowerdim=16,
               num_queries=2, qk_norm=True, dtype="float32",
               norm_first=False, attn_impl="pallas")
MODES = [pytest.param(False, id="tok"), pytest.param(True, id="cont")]
# as tests/test_torch_train.py: elements whose gradient is zero up to
# rounding (every key bias shifts a row's keys alike) move by at most twice
# the step's rate
NOISE = 1e-4
ZERO_GRAD = ("key.bias", "k_norm.bias")
TOL = dict(rtol=1e-5, atol=1e-5)


def _cfg(cont, **over):
    kw = dict(POST_LN, use_continuous=cont,
              vocab_size=RESOLUTION ** 2 + 4)
    if cont:
        kw["num_mixtures"] = 3
    kw.update(over)
    return JaxConfig(**kw)


def _batches(cont, n=1):
    kw = dict(token_mode=False) if cont else dict(
        token_mode=True, tokenizer=GridTokenizer(RESOLUTION))
    it = get_dataloader_by_name("synthetic")(
        num_classes=5, sketches_per_epoch=64, batch_size=8, buckets=(24,),
        seed=0, **kw).batch_iterator("train")
    return [next(it) for _ in range(n)]


def _jax_state(model, batch):
    tx = make_optimizer(model.config.d_model, warmup_steps=WARMUP,
                        peak_scale=PEAK)
    state = jax_create_state(model, tx, jax.random.PRNGKey(0), batch)
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
            a.shape).astype(np.float32), state.params)
    return tx, JaxTrainState(params, tx.init(params), state.step, state.rng)


def _inputs(cfg):
    if cfg.use_continuous:
        rows, mask = cont_batch(cfg)
        return (rows, mask)
    return (token_batch(cfg),)


@pytest.mark.parametrize("cont", MODES)
def test_post_ln_embed_and_logits_match_jax(cont, caplog):
    """z and the class logits within 1e-5 of the JAX model's; both
    encoders decline their fused stacks with the note "post-LN config",
    and on CPU tensors K8 runs its plain version (no launch counted)."""
    model = JaxSketchformer(_cfg(cont, max_len=32))
    enc = _inputs(model.config)
    params = model.init(jax.random.PRNGKey(0), enc[0],
                        enc[0] if not cont else np.zeros(
                            (*enc[0].shape[:2], 5), np.float32))["params"]
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * np.random.default_rng(2)
        .standard_normal(np.shape(a)).astype(np.float32), params)
    want = model.apply({"params": params}, *map(jnp.asarray, enc),
                       method=JaxSketchformer.embed)
    want_logits = model.apply({"params": params}, want,
                              method=lambda m, z: m.classifier(z))
    port = port_model(model, params)
    reset_seen()
    fa.reset_launches()
    with caplog.at_level(logging.WARNING,
                         logger="sketchformer_tpu_torch.engines"):
        with torch.no_grad():
            got = port.embed(*map(torch.from_numpy, enc))
            logits = port.classify(got)
    assert "encoder-stack: using composed path — post-LN config" in \
        caplog.text
    assert fa.LAUNCHES["flash_attention_fwd"] == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               **TOL)


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


@pytest.mark.parametrize("cont", MODES)
def test_post_ln_train_step_matches_jax(cont):
    """One step of the post-LN pallas model: loss rtol 1e-4, every metric
    and the grad norm rtol 1e-4 (atol 1e-6), the updated parameters rtol
    1e-4 / atol 1e-5 (elements whose gradient is zero up to rounding
    within twice the step's rate), as tests/test_torch_train.py holds the
    pre-LN step; K8's backward is in the gradient."""
    batch = _batches(cont)[0]
    model = JaxSketchformer(_cfg(cont))
    tx, state = _jax_state(model, batch)
    new_state, want = jax_make_train_step(model, tx)(state, jax_pack(batch))
    port = port_model(model, state.params).train()
    st = create_train_state(port, 0, WARMUP, PEAK)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    got = make_train_step(st)(pack_batch(batch))
    assert set(got) == set(want)
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                               rtol=1e-4)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    # the step's gradients, from the JAX loss at the old parameters
    grads = jax.grad(lambda p: _jax_loss(model, p, batch))(state.params)
    flat = params_from_flax(grads)
    rate = PEAK * model.config.d_model ** -0.5 * WARMUP ** -1.5
    _check_params(port, new_state.params, flat, rate)
    assert any(not torch.equal(v, before[k])
               for k, v in port.state_dict().items())


def _jax_loss(model, params, batch):
    """The JAX step's training loss at ``params`` (its grad is the step's
    gradient)."""
    from sketchformer_tpu.data.packed import unpack_batch
    from sketchformer_tpu.train.loss import (
        cont_multitask_loss,
        tok_multitask_loss,
    )

    full = unpack_batch(jax_pack(batch))
    cfg = model.config
    if cfg.use_continuous:
        out = model.apply({"params": params}, full["enc"], full["dec_in"],
                          full["enc_mask"], full["dec_mask"])
        return cont_multitask_loss(out, full, cfg.num_mixtures)[0]
    out = model.apply({"params": params}, full["enc"], full["dec_in"])
    return tok_multitask_loss(out, full)[0]


@pytest.mark.parametrize("cont", MODES)
def test_post_ln_eval_step_matches_jax(cont):
    """The eval step: every metric rtol 1e-4, atol 1e-6."""
    batch = _batches(cont)[0]
    model = JaxSketchformer(_cfg(cont))
    _, state = _jax_state(model, batch)
    want = jax_make_eval_step(model)(state.params, jax_pack(batch))
    got = make_eval_step(port_model(model, state.params))(pack_batch(batch))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("cont", MODES)
def test_post_ln_greedy_decode_matches_jax(cont):
    """Greedy decodes (the chunk engine declines post-LN in both packages;
    the composed decoder's encoder runs K8 and its cached self-attention
    the decode-attention kernel K12): token ids exactly equal, MDN xy
    within 1e-5 and pen / valid equal."""
    model = JaxSketchformer(_cfg(cont))
    enc = _inputs(model.config)
    _, state = _jax_state(model, _batches(cont)[0])
    port = port_model(model, state.params)
    if cont:
        want = jdec.make_cont_decoder(model, early_exit=False)(
            state.params, *map(jnp.asarray, enc), jax.random.PRNGKey(0))
        got = tdec.make_cont_decoder(port)(*map(torch.from_numpy, enc))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=1e-5, atol=1e-5)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        return
    want = jdec.make_token_decoder(model, fast=False)(
        state.params, jnp.asarray(enc[0]))
    got = tdec.make_token_decoder(port)(torch.from_numpy(enc[0]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_post_ln_checkpoint_keys_round_trip():
    """A post-LN model has no ``ln_out`` in either stack; its state_dict
    maps onto the flax tree and back leaf for leaf."""
    model = JaxSketchformer(_cfg(True))
    _, state = _jax_state(model, _batches(True)[0])
    port = port_model(model, state.params)
    keys = set(port.state_dict())
    assert not any(k.startswith(("encoder.ln_out", "decoder.ln_out"))
                   for k in keys)
    assert "encoder.layer_0.ln2.scale" in keys
    back = params_to_flax(port.state_dict())
    want = jax.tree_util.tree_leaves_with_path(state.params)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [jax.tree_util.keystr(k) for k, _ in got] == \
        [jax.tree_util.keystr(k) for k, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_post_ln_cli_train_then_eval(tmp_path, capsys, caplog):
    """``train`` / ``eval`` with ``--hparams norm_first=False`` on the CPU:
    finite metrics, the eval of the checkpoint equal to the run's last
    validation loss, and the stacks' decline noted."""
    run = str(tmp_path / "run")
    hp = ("norm_first=False,num_layers=2,d_model=64,num_heads=4,dff=128,"
          "lowerdim=16,max_len=24,dtype=float32")
    reset_seen()
    with caplog.at_level(logging.WARNING,
                         logger="sketchformer_tpu_torch.engines"):
        assert cli.main([
            "train", "--preset", "cont2cont_mdn", "--run-dir", run,
            "--device", "cpu", "--hparams", hp, "--loader-arg",
            "batch_size=8", "--loader-arg", "buckets=[24]", "--loader-arg",
            "sketches_per_epoch=64", "--notifier", "none", "--loop-arg",
            "total_steps=3", "--loop-arg", "eval_every=3", "--loop-arg",
            "save_every=3", "--loop-arg", "warmup_steps=2"]) == 0
    final = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(final["val_loss"])
    assert "decoder-stack: using composed path — post-LN config" in \
        caplog.text
    assert cli.main(["eval", "--run-dir", run, "--device", "cpu"]) == 0
    ev = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ev["loss"] == pytest.approx(final["val_loss"], rel=1e-3)
