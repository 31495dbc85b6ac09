"""The drivers: one general generator and window driver for each path a
traffic file can name (``"path"``: ``embed``, ``decode`` or ``train``).

Each driver makes its inputs and weights from the seed, builds the
program's entry, warms up the cell's own shapes, runs the measured window
(closed loop: the next unit starts when the last one has returned), and
afterwards holds a sample of what the window produced to the plain
reference. Inputs are drawn so that every seed gives the same set of
sizes in another order: the sketches' lengths are a fixed multiset
spread evenly over [len_min, len_max], permuted by the seed; token ids,
stroke rows, labels and weights are drawn from the seed.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from perfbench import devtrace as tr, harness
from perfbench.reference import model as R
from perfbench.reference import philox

WARM_UNITS = 2          # units run before the window, on the cell's shapes
REF_BLOCK = 128         # rows the reference computes at a time


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def lengths(rng: np.random.Generator, n: int, lo: int, hi: int) -> np.ndarray:
    """n sketch lengths in [lo, hi]: the same multiset for every seed (an
    even spread), in the seed's order."""
    spread = lo + (np.arange(n) * (hi - lo + 1)) // n
    return rng.permutation(spread).astype(np.int64)


def sketches(cfg: dict, traffic: dict, rng: np.random.Generator
             ) -> List[dict]:
    """The pool of batches: token ids (n grid tokens, EOS, then PAD) or
    stroke-3 rows (n rows of (dx, dy, pen lifted), then zeros) with their
    ``n``, ``enc_mask`` and labels; ``keys`` is each row's number of
    valid encoder keys."""
    P, B, T = traffic["pool"], traffic["batch"], traffic["seq_len"]
    n = lengths(rng, P * B, traffic["len_min"],
                min(traffic["len_max"], T - 1)).reshape(P, B)
    pos = np.arange(T)[None, :]
    pool = []
    for p in range(P):
        labels = rng.integers(0, cfg["num_classes"], B).astype(np.int32)
        if cfg["use_continuous"]:
            rows = rng.standard_normal((B, T, 3)).astype(np.float32)
            rows[..., 2] = (rng.random((B, T)) < 0.1).astype(np.float32)
            real = pos < n[p][:, None]
            rows *= real[..., None]
            pool.append({"enc": rows, "n": n[p].astype(np.int32),
                         "enc_mask": real.astype(np.float32),
                         "label": labels, "keys": n[p]})
        else:
            ids = rng.integers(4, cfg["vocab_size"], (B, T)).astype(np.int32)
            ids[pos == n[p][:, None]] = R.EOS_ID
            ids[pos > n[p][:, None]] = R.PAD_ID
            pool.append({"enc": ids, "label": labels, "keys": n[p] + 1})
    return pool


def to_device(b: dict, dev) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(dev) for k, v in b.items()
            if k in ("enc", "n", "label")}


def sample(seed: int, n: int, k: int) -> List[int]:
    """k distinct unit indices of n, drawn from the seed; the last unit
    always among them."""
    rng = np.random.default_rng([seed, 7])
    if n <= k:
        return list(range(n))
    rest = rng.choice(n - 1, size=k - 1, replace=False)
    return sorted(int(i) for i in rest) + [n - 1]


def set_reference_precision() -> None:
    """The reference's products in true float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# the traced sub-window
# ---------------------------------------------------------------------------


class Tracer:
    """Opens the profiler before unit ``at`` and closes it before unit
    ``at + n`` of the window; a trace that lost events is refused and a
    second one is taken a few units later."""

    def __init__(self, enabled: bool, at: int, n: int) -> None:
        self.enabled = enabled
        self.at, self.n = at, n
        self.sub: Optional[tr.SubWindow] = None
        self.trace: Optional[tr.Trace] = None
        self.refused = 0
        self.traced: List[int] = []

    @property
    def open(self) -> bool:
        return self.sub is not None

    def before(self, unit: int) -> None:
        if not self.enabled or self.trace is not None:
            return
        if self.sub is None and unit == self.at:
            self.sub = tr.SubWindow()
            self.sub.start()
            self.first = unit
        elif self.sub is not None and unit == self.first + self.n:
            self.sub.stop()
            got = tr.Trace(self.sub.prof, self.n)
            self.sub = None
            if got.lost and self.refused == 0:
                self.refused += 1
                self.at = unit + 2
                return
            if not got.lost:
                self.trace = got
                self.traced = list(range(self.first, self.first + self.n))
            else:
                self.refused += 1
                self.enabled = False


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------


class Driver:
    """Set-up, window and check of one cell; ``metrics`` holds the
    window's end-to-end numbers, ``attempted`` / ``failed`` its units, and
    ``check()`` the numbers the output check compares."""

    def __init__(self, cell: harness.Cell, seed: int, device) -> None:
        self.cell = cell
        self.cfg = cell.cfg
        self.traffic = cell.traffic
        self.seed = seed
        self.dev = device
        self.rng = np.random.default_rng([seed, 1])
        self.pool = sketches(self.cfg, self.traffic, self.rng)
        self.metrics: Dict[str, float] = {}
        self.attempted = self.failed = 0
        self.tracer: Optional[Tracer] = None

    def sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def new_tracer(self, enabled: bool) -> Tracer:
        t = self.traffic
        self.tracer = Tracer(enabled, t["trace_at"], t["trace_units"])
        return self.tracer

    def traced_inputs(self) -> List[dict]:
        if self.tracer is None:
            return []
        return [self.unit_inputs(u) for u in self.tracer.traced]

    def unit_inputs(self, unit: int) -> dict:
        return {"keys": self.pool[unit % len(self.pool)]["keys"]}

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        for k in list(vars(self)):
            if k.startswith("prog_"):
                delattr(self, k)
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference_params(self) -> Dict[str, torch.Tensor]:
        return harness.make_params(self.cfg, self.seed, self.dev)


class EmbedPath(Driver):
    """Gallery embedding through ``embed_dataset``: a generator that
    cycles the pool's host batches and stops yielding at the window's end;
    the rate counts the z's that reached the host."""

    def setup(self) -> None:
        from sketchformer_tpu_torch.infer.encode import embed_dataset

        self.embed_dataset = embed_dataset
        params = harness.make_params(self.cfg, self.seed, self.dev)
        self.prog_model = harness.program_model(self.cfg, params,
                                                self.dev).eval()
        del params
        self.host = [{k: v for k, v in b.items() if k != "keys"}
                     for b in self.pool]
        embed_dataset(self.prog_model, iter(self.host[:WARM_UNITS]))
        self.sync()

    def window(self, seconds: float, tracer: Tracer) -> None:
        P = len(self.host)
        count = 0
        t0 = time.perf_counter()
        deadline = t0 + seconds

        def batches():
            nonlocal count
            while True:
                tracer.before(count)
                if time.perf_counter() >= deadline and not tracer.open:
                    return
                yield self.host[count % P]
                count += 1

        Z, _ = self.embed_dataset(self.prog_model, batches())
        t1 = time.perf_counter()
        self.Z = Z
        self.attempted = count
        self.failed = count - Z.shape[0] // self.traffic["batch"]
        self.metrics["embed_sketches_per_s"] = Z.shape[0] / (t1 - t0)

    def check(self) -> Dict[str, float]:
        """``z_err``: the widest relative L2 gap of a z row of the sampled
        batches from the reference's."""
        B = self.traffic["batch"]
        picks = sample(self.seed, self.attempted, self.traffic["check_units"])
        worst = 0.0
        ref = R.Reference(self.cfg, self.reference_params())
        with torch.no_grad():
            for i in picks:
                z_ref = embed_reference(ref, self.pool[i % len(self.pool)],
                                        self.dev)
                z = torch.as_tensor(self.Z[i * B:(i + 1) * B]).to(self.dev)
                worst = max(worst, row_gap(z, z_ref))
        return {"z_err": worst}


def embed_reference(ref: R.Reference, b: dict, dev) -> torch.Tensor:
    full = R.full_batch(to_device(b, dev), ref.cfg["use_continuous"])
    if ref.cfg["use_continuous"]:
        full["enc"] = full["enc"].float()
    zs = []
    for r0 in range(0, full["enc"].shape[0], REF_BLOCK):
        sl = slice(r0, r0 + REF_BLOCK)
        z, _ = ref.encode(full["enc"][sl], full["enc_key"][sl])
        zs.append(z)
    return torch.cat(zs)


def row_gap(z: torch.Tensor, z_ref: torch.Tensor) -> float:
    num = torch.linalg.vector_norm(z.float() - z_ref, dim=-1)
    den = torch.linalg.vector_norm(z_ref, dim=-1).clamp_min(1e-30)
    return float((num / den).max())


class DecodePath(Driver):
    """Interactive reconstruction: each request copies a pool batch of
    prompts to the card, runs ``make_token_decoder``'s greedy decode and
    copies the ids back; latency is host clock from the call to the ids
    on the host."""

    def setup(self) -> None:
        from sketchformer_tpu_torch.infer.decode import make_token_decoder

        if self.cfg["use_continuous"]:
            raise ValueError("the decode driver serves token models")
        params = harness.make_params(self.cfg, self.seed, self.dev)
        self.prog_model = harness.program_model(self.cfg, params,
                                                self.dev).eval()
        del params
        pin = self.dev.type == "cuda"
        self.host = [torch.from_numpy(b["enc"]) for b in self.pool]
        if pin:
            self.host = [h.pin_memory() for h in self.host]
        self.prog_decode = make_token_decoder(
            self.prog_model, max_len=self.traffic["decode_len"])
        for i in range(WARM_UNITS):
            self.request(i)
        self.sync()

    def request(self, i: int) -> torch.Tensor:
        enc = self.host[i % len(self.host)].to(self.dev, non_blocking=True)
        return self.prog_decode(enc).cpu()

    def window(self, seconds: float, tracer: Tracer) -> None:
        self.outs: List[torch.Tensor] = []
        lat = []
        i = 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            tracer.before(i)
            if time.perf_counter() >= deadline and not tracer.open:
                break
            ts = time.perf_counter()
            self.outs.append(self.request(i))
            lat.append(time.perf_counter() - ts)
            i += 1
        t1 = time.perf_counter()
        B = self.traffic["batch"]
        self.attempted = i
        self.metrics["decode_p95_ms"] = float(np.percentile(lat, 95)) * 1e3
        self.metrics["decode_sketches_per_s"] = B * i / (t1 - t0)

    def check(self) -> Dict[str, float]:
        """``logit_gap``: the widest gap by which a served token's
        reference logit lies below the reference's best (PAD and SOS
        excluded, as the greedy decode excludes them), over the sampled
        requests' tokens up to each row's EOS."""
        picks = sample(self.seed, self.attempted,
                       self.traffic["check_units"])
        ref = R.Reference(self.cfg, self.reference_params())
        worst = 0.0
        with torch.no_grad():
            for i in picks:
                prompt = torch.as_tensor(
                    self.pool[i % len(self.pool)]["enc"]).to(self.dev)
                served = self.outs[i].to(self.dev).long()
                worst = max(worst, decode_gap(ref, prompt, served))
        return {"logit_gap": worst}


def decode_logits(ref: R.Reference, prompt: torch.Tensor,
                  served: torch.Tensor) -> torch.Tensor:
    """The teacher-forced logits over the served tokens, PAD and SOS at
    -inf."""
    _, memory = ref.encode(prompt, prompt != R.PAD_ID)
    dec_in = torch.cat([torch.full_like(served[:, :1], R.SOS_ID),
                        served[:, :-1]], dim=1)
    logits = ref.head(ref.decode(dec_in, memory, dec_in != R.PAD_ID))
    logits[..., R.PAD_ID] = -float("inf")
    logits[..., R.SOS_ID] = -float("inf")
    return logits


def decode_gap(ref: R.Reference, prompt: torch.Tensor, served: torch.Tensor,
               ctrl: Optional[R.Reference] = None) -> float:
    """The widest gap of the served tokens (or, with ``ctrl``, of the
    tokens the control puts first at each position of the same prompts
    and tokens), in blocks of rows."""
    worst = 0.0
    for r0 in range(0, prompt.shape[0], REF_BLOCK // 4):
        sl = slice(r0, r0 + REF_BLOCK // 4)
        logits = decode_logits(ref, prompt[sl], served[sl])
        picked = served[sl]
        if ctrl is not None:
            picked = decode_logits(ctrl, prompt[sl], served[sl]).argmax(-1)
        # positions up to and including each row's first EOS
        eos = (served[sl] == R.EOS_ID).int()
        live = torch.cumsum(eos, dim=1) - eos == 0
        best = logits.max(dim=-1).values
        got = logits.gather(-1, picked[..., None])[..., 0]
        gap = torch.where(live, best - got, torch.zeros_like(best))
        worst = max(worst, float(gap.max()))
    return worst


class TrainPath(Driver):
    """Training through ``make_train_step``: set-up builds the step with
    its model and optimizer state and drives its first ``checked_steps``
    steps on the pool's first batches (rows that all differ), recording
    the losses, the first gradient (from the optimizer's first moment) and
    the parameters after them; the window then runs the same object's
    steps over the pool, back to back, and ends at a synchronise. After
    the window, the same object runs one more step on the next batch of
    the cycle, with its state before and after copied to the host: the
    check holds that step to the reference's from the same state."""

    def setup(self) -> None:
        from sketchformer_tpu_torch.train.step import (
            create_train_state,
            make_train_step,
        )

        t = self.traffic
        self.host = [{k: v for k, v in b.items()
                      if k in ("enc", "n", "label")} for b in self.pool]
        params = harness.make_params(self.cfg, self.seed, self.dev)
        model = harness.program_model(self.cfg, params, self.dev)
        del params
        state = create_train_state(model, self.seed, t["warmup_steps"],
                                   t["peak_scale"])
        step = make_train_step(state)
        self.names = [n for n, _ in model.named_parameters()]
        self.losses, self.grad1 = [], {}
        for s in range(t["checked_steps"]):
            m = step(self.host[s])
            self.losses.append(float(m["loss"]))
            if s == 0:   # the first moment is (1 - b1) g after one update
                self.grad1 = {n: mu / (1 - state.opt.b1)
                              for n, mu in zip(self.names, state.opt.mu)}
        self.after = {n: p.detach().clone()
                      for n, p in model.named_parameters()}
        self.applied0 = state.opt.count
        self.prog_state, self.prog_step = state, step
        self.sync()

    def window(self, seconds: float, tracer: Tracer) -> None:
        first = self.traffic["checked_steps"]
        P = len(self.host)
        i = 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            tracer.before(i)
            if time.perf_counter() >= deadline and not tracer.open:
                break
            self.prog_step(self.host[(first + i) % P])
            i += 1
        self.sync()
        t1 = time.perf_counter()
        self.attempted = i
        self.failed = i - (self.prog_state.opt.count - self.applied0)
        self.metrics["train_sketches_per_s"] = (
            self.traffic["batch"] * i / (t1 - t0))
        self.window_step((first + i) % P)

    def window_step(self, batch: int) -> None:
        """One more step of the same object on pool batch ``batch``; the
        parameters and moments before it and after it go to the host (so
        the device's peak stays the window's)."""
        state = self.prog_state
        opt = state.opt

        def host(ts):
            return {n: t.detach().to("cpu", copy=True)
                    for n, t in zip(self.names, ts)}

        params = list(state.model.parameters())
        self.win = {"batch": batch, "step": state.step, "count": opt.count,
                    "b1": opt.b1, "params": host(params), "mu": host(opt.mu),
                    "nu": host(opt.nu)}
        m = self.prog_step(self.host[batch])
        self.win.update(loss=float(m["loss"]), after=host(params),
                        mu_after=host(opt.mu))

    def unit_inputs(self, unit: int) -> dict:
        b = self.pool[(self.traffic["checked_steps"] + unit) % len(self.pool)]
        if self.cfg["use_continuous"]:
            dec = np.minimum(b["n"] + 1, self.traffic["seq_len"])
        else:
            dec = np.minimum(b["keys"], self.traffic["seq_len"])
        return {"keys": b["keys"], "dec_keys": dec}

    def program_steps(self) -> dict:
        """What the program's steps produced: the first steps' losses,
        first gradient and parameters after them, and the window step's
        loss, gradient (from its first moment before and after) and
        parameters after it."""
        w, b1 = self.win, self.win["b1"]
        grad = {n: (w["mu_after"][n].double() - b1 * w["mu"][n].double())
                / (1 - b1) for n in self.names}
        return {"first": {"losses": self.losses, "grad1": self.grad1,
                          "after": self.after},
                "win": {"losses": [w["loss"]], "grad1": grad,
                        "after": w["after"]}}

    def check(self) -> Dict[str, float]:
        """The program's first steps and its step after the window against
        the reference's, on the same batches and dropout masks, from the
        seed's weights and from the program's state before that step:
        see :func:`train_numbers`."""
        return train_numbers(self.program_steps(), reference_pair(self))


def reference_grads(drv: "TrainPath", P: dict, batch: int, step: int,
                    q: Callable, half: bool) -> Tuple[float, dict]:
    """The reference's loss and gradients of pool batch ``batch`` at the
    program's step ``step`` (its dropout key), in blocks of rows."""
    cfg, dev = drv.cfg, drv.dev
    cont = cfg["use_continuous"]
    b = to_device(drv.host[batch], dev)
    if cont:
        b["enc"] = b["enc"].float()
    if half:
        keep = b["enc"].shape[0] // 2
        b = {k: v[:keep] for k, v in b.items()}
    full = R.full_batch(b, cont)
    denoms = R.denominators(full, cont)
    for p in P.values():
        p.grad = None
    total = 0.0
    B = full["enc"].shape[0]
    for r0 in range(0, B, REF_BLOCK):
        rows = torch.arange(r0, min(B, r0 + REF_BLOCK), device=dev)
        blk = {k: v[r0:r0 + REF_BLOCK] for k, v in full.items()}
        drop = philox.StepDropout((drv.seed, step, 0), cfg["dropout"], rows)
        loss = R.train_loss(R.Reference(cfg, P, q, drop), blk, denoms)
        loss.backward()
        total += float(loss.detach())
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in P.items()}
    return total, grads


def reference_pair(drv: "TrainPath", q: Callable = R.exact,
                   half: bool = False) -> dict:
    """The reference's first steps from the seed's weights (losses, first
    clipped gradient, the parameters before and after them) and its step
    from the program's state before the window step (``"win"``)."""
    cfg, t, dev = drv.cfg, drv.traffic, drv.dev
    P = {k: v.clone().requires_grad_(True)
         for k, v in drv.reference_params().items()}
    start = {k: v.detach().clone() for k, v in P.items()}
    opt = R.Adam(P, cfg["d_model"], t["warmup_steps"], t["peak_scale"])
    losses, grad1 = [], {}
    for s in range(t["checked_steps"]):
        loss, grads = reference_grads(drv, P, s, s, q, half)
        losses.append(loss)
        clipped = opt.update(P, grads)
        if s == 0:
            grad1 = {k: g.detach().clone() for k, g in clipped.items()}
    first = {"losses": losses, "grad1": grad1, "start": start,
             "after": {k: v.detach() for k, v in P.items()}}
    del P, opt
    w = drv.win
    P = {k: v.to(dev, copy=True).requires_grad_(True)
         for k, v in w["params"].items()}
    opt = R.Adam(P, cfg["d_model"], t["warmup_steps"], t["peak_scale"])
    opt.count = w["count"]
    opt.m = {k: v.to(dev, copy=True) for k, v in w["mu"].items()}
    opt.v = {k: v.to(dev, copy=True) for k, v in w["nu"].items()}
    loss, grads = reference_grads(drv, P, w["batch"], w["step"], q, half)
    clipped = opt.update(P, grads)
    win = {"losses": [loss], "grad1": clipped, "start": w["params"],
           "after": {k: v.detach() for k, v in P.items()}}
    return {"first": first, "win": win}


def train_numbers(got: dict, want: dict, detail: bool = False
                  ) -> Dict[str, float]:
    """The numbers a training cell compares (``got``: the program's steps,
    or a stand-in's; ``want``: the reference's; both as
    :func:`reference_pair` gives them): :func:`compare_steps` of the first
    steps, and of the window step under names that begin ``win_``."""
    out = compare_steps(got["first"], want["first"], detail)
    out.update({"win_" + k: v for k, v in compare_steps(
        got["win"], want["win"], detail).items()})
    return out


def _leaf(x) -> torch.Tensor:
    return x.detach().double().cpu()


def compare_steps(got: dict, want: dict, detail: bool = False
                  ) -> Dict[str, float]:
    """The numbers of one run of steps against the reference's; a leaf's
    gap is over the larger of its reference norm and the median leaf's:

    - ``loss_err``: the widest relative gap of a step's loss;
    - ``grad_err``: the worst leaf's gap between the norms of the first
      gradient;
    - ``grad_dev`` and ``grad_dev_med``: the worst and the median leaf's
      norm of the first gradient's difference;
    - ``change_err`` and ``change_dev``: the worst leaf's gap of norms and
      norm of the difference of the parameters' change over the steps,
      leaving out the leaves whose reference gradient is below a
      thousandth of the median leaf's (a key's bias under softmax: nought
      but rounding, which Adam's normalisation blows up).

    ``detail`` adds the first step's loss gap and the five leaves with
    the worst ``grad_dev`` (the control tool's record)."""
    loss_err = max(abs(a - b) / abs(b)
                   for a, b in zip(got["losses"], want["losses"]))
    g_ref = {k: _leaf(g) for k, g in want["grad1"].items()}
    g_got = {k: _leaf(got["grad1"][k]) for k in g_ref}
    gnorm = {k: float(g.norm()) for k, g in g_ref.items()}
    gmed = float(np.median(list(gnorm.values())))
    g_gap = {k: abs(float(g_got[k].norm()) - gnorm[k]) / max(gnorm[k], gmed)
             for k in gnorm}
    g_dev = {k: float((g_got[k] - g_ref[k]).norm()) / max(gnorm[k], gmed)
             for k in gnorm}
    kept = [k for k in gnorm if gnorm[k] >= 1e-3 * gmed]
    d_ref = {k: _leaf(want["after"][k]) - _leaf(want["start"][k])
             for k in kept}
    d_got = {k: _leaf(got["after"][k]) - _leaf(want["start"][k])
             for k in kept}
    dnorm = {k: float(d.norm()) for k, d in d_ref.items()}
    dmed = float(np.median(list(dnorm.values())))
    out = {"loss_err": loss_err, "grad_err": max(g_gap.values()),
           "grad_dev": max(g_dev.values()),
           "grad_dev_med": float(np.median(list(g_dev.values()))),
           "change_err": max(abs(float(d_got[k].norm()) - dnorm[k])
                             / max(dnorm[k], dmed) for k in kept),
           "change_dev": max(float((d_got[k] - d_ref[k]).norm())
                             / max(dnorm[k], dmed) for k in kept)}
    if detail:
        out.update(loss1_err=abs(got["losses"][0] - want["losses"][0])
                   / abs(want["losses"][0]),
                   grad_dev_worst=sorted(g_dev.items(),
                                         key=lambda kv: -kv[1])[:5])
    return out


PATHS = {"embed": EmbedPath, "decode": DecodePath, "train": TrainPath}
