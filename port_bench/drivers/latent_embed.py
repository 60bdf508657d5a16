"""The codec-latent embed (``SemanticWM(codec, "pca").embed`` at its
operating point): Adam on a waveform perturbation through the codec
encoder, batch after batch from a pool made from the seed, back to back,
one caller.  Each call goes through ``SemanticWM.embed``, which builds the
PCA axis, pads the batch and makes the embed's tables before its steps.

The window is counted in Adam steps: an optimizer pre-step hook opens it
at a step boundary of the first call after a synchronise and closes it at
the first boundary past ``--seconds``, after another.  ``step_ms`` is the
window's wall time over the steps in it.  A window longer than one call
(300 steps) crosses into the next call, so it holds that call's own work
before its first step and the boundary between the two.  The first call
always runs to its end (its output is checked); a later call is cut at the
step boundary after the window (and, traced, the profiled steps) closed.

Checked: steps of the first timed call, from the states the timed path
produced (read by the same hook): the first step (from zero), one step of
the window and one phase end drawn from the seed, and the last step with
the marked audio it returns.  For each, the reference's masked gradient at
the program's delta against the program's, and the reference's Adam step,
budget and (at a phase end) spectral projection from the program's delta,
gradient and Adam state against the program's next delta (or its output).
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time
import weakref

import torch
from torch.optim.optimizer import register_optimizer_step_pre_hook

from port_bench import counts, harness, inputs
from port_bench.reference import codec as ref_codec
from port_bench.reference import precision
from port_bench.reference import semantic as ref_sem
from port_bench.weights import make_codec

SCFG_FIELDS = ("steps", "lr", "dynamic_eps", "target_sdr_db", "cap_mult", "pn_seed", "ma_window",
               "lsd_weight", "proj_headroom_db", "n_proj_phases", "proj_free_above_hz",
               "proj_stoi_extra_db")


class WindowClosed(Exception):
    """Raised by the step hook to cut a call after the window."""


class StepHook:
    """The optimizer pre-step hook: opens and closes the window at step
    boundaries and keeps the states of the checked steps."""

    def __init__(self, device, seconds: float, open_after: int, checked: set[int],
                 profile_steps: int = 0):
        self.device, self.seconds, self.open_after, self.checked = device, seconds, open_after, checked
        self.call = -1  # the timed call the steps belong to
        self.start = self.end = None
        self.steps = 0
        self.kept: dict[int, dict] = {}
        self.profile_steps, self.profiled, self.prof = profile_steps, 0, None
        self.profile = None if profile_steps else {}
        self.seen = 0  # every step the hook saw
        self.opt, self.k = None, 0  # the embed's optimizer and its steps so far

    @property
    def done(self) -> bool:
        return self.end is not None and self.profile is not None

    def __call__(self, opt, args, kwargs):
        (delta,) = opt.param_groups[0]["params"]
        state = opt.state.get(delta, {})
        if self.opt is None or self.opt() is not opt:
            self.opt, self.k = weakref.ref(opt), 0
        self.k += 1
        k = self.k
        self.seen += 1
        if self.done and self.call >= 1:
            raise WindowClosed
        if self.call == 0:
            if k - 1 in self.kept and "after" not in self.kept[k - 1]:
                self.kept[k - 1]["after"] = delta.detach().clone()
            if k in self.checked:
                self.kept[k] = {"delta": delta.detach().clone(), "grad": delta.grad.detach().clone(),
                                "m": state["exp_avg"].clone() if state else None,
                                "v": state["exp_avg_sq"].clone() if state else None,
                                "t": int(state["step"]) if state else 0}
        if self.start is None and self.call == 0 and k == self.open_after + 1:
            harness.sync(self.device)
            self.start = time.perf_counter()
        elif self.start is not None and self.end is None:
            self.steps += 1
            if time.perf_counter() - self.start >= self.seconds:
                harness.sync(self.device)
                self.end = time.perf_counter()
                if self.profile_steps:  # the traced run profiles the steps after the window
                    self.prof = harness.ProfileWindow(self.device)
                    self.prof.open()
        elif self.prof is not None and self.profile is None:
            self.profiled += 1
            if self.profiled == self.profile_steps:
                self.profile = self.prof.close(self.profile_steps)
        return None


def run(run) -> dict:
    from nawc_tpu_torch.models.semantic import SemanticWM

    cfg, tr, dev = run.config, run.traffic, run.device
    scfg_block = cfg["semantic"]
    harness.program_float32()
    codec, weights = make_codec(cfg["codec"], run.seed, dev)
    run.mark("weights")
    wm = SemanticWM(codec, scfg_block["axis"])
    got = {f: getattr(wm.scfg, f) for f in SCFG_FIELDS}
    if got != {f: scfg_block[f] for f in SCFG_FIELDS}:
        raise ValueError(f"the configuration's semantic block is not the program's {got}")
    scfg = wm.scfg
    n_samples = int(round(tr["seconds"] * tr["sample_rate"]))
    r = inputs.rng(run.seed, "latent embed")
    batches = [torch.from_numpy(inputs.speech_clips(r, tr["batch"], n_samples, tr["sample_rate"]))
               .to(dev) for _ in range(tr["pool_batches"])]
    run.mark("inputs")
    # set-up: every shape of the window, in one short embed (one step a phase)
    SemanticWM(codec, scfg_block["axis"],
               cfg=dataclasses.replace(scfg, steps=scfg.n_proj_phases)).embed(batches[0])
    harness.sync(dev)

    steps = scfg.steps
    per_phase = steps // scfg.n_proj_phases
    pick = inputs.rng(run.seed, "checked steps")
    checked = {1, int(pick.integers(tr["open_after_step"] + 2, per_phase)),
               per_phase * int(pick.integers(1, scfg.n_proj_phases)), steps}
    hook = StepHook(dev, run.seconds, tr["open_after_step"], checked,
                    tr["profile_steps"] if run.trace else 0)
    handle = register_optimizer_step_pre_hook(hook)
    run.setup_done()

    outputs = []
    record = {}
    try:
        i = 0
        while not hook.done:
            hook.call, seen = i, hook.seen
            try:
                out = wm.embed(batches[i % len(batches)])
            except WindowClosed:
                break
            if hook.seen == seen or hook.start is None:
                raise RuntimeError("the embed made no optimizer step that opens the window")
            if i == 0:
                outputs.append(out)
            i += 1
        harness.sync(dev)
    finally:
        handle.remove()
    run.read_peak()
    del codec, wm
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    if run.trace:
        enc, _ = counts.codec_layers(cfg["codec"], tr["batch"],
                                     ref_codec.pad_to(batches[0], ref_codec.chunk(cfg["codec"])).shape[-1])
        dtype = cfg["codec"]["compute_dtype"]
        record = {"calls": hook.steps, "spans": {}, "profile": dict(hook.profile, unit="step"),
                  "work": {"flops": 2 * counts.conv_flops(enc), "peak_flops": counts.PEAK_FLOPS[dtype],
                           "snake_bytes": counts.snake_bytes(enc, dtype, backward=True)}}
    kept = hook.kept
    if steps in kept:
        kept[steps]["out"] = outputs[0]
    if run.mode == "control":
        kept = control_states(cfg, weights, batches[0], run.control)
    checks = judge(cfg, weights, batches[0], kept)
    return {"e2e": {"step_ms": (hook.end - hook.start) / hook.steps * 1e3},
            "attempted": hook.steps, "failed": 0, "record": record, "checks": checks}


def control_states(cfg, weights, batch, control: str) -> dict:
    """The reference at the control's precision in the program's place:
    its first three steps from zero, kept as the hook keeps the program's."""
    prec = precision.get(control)
    precision.no_tf32()
    emb = ref_sem.Embed(ref_codec.Codec(weights, cfg["codec"], prec), cfg["semantic"], batch)
    delta = torch.zeros_like(emb.x)
    m = v = torch.zeros_like(emb.x)
    kept = {}
    for k in range(1, 4):
        g = emb.grad(delta)
        kept[k] = {"delta": delta, "grad": g, "m": m if k > 1 else None,
                   "v": v if k > 1 else None, "t": k - 1}
        nxt, m, v = emb.adam(delta, g, m, v, k - 1, cfg["semantic"]["lr"])
        delta = emb.budget(nxt)
        kept[k]["after"] = delta
    return kept


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest per-clip norm of a - b over the norm of b."""
    d = (a.double() - b.double()).norm(dim=-1)
    return float((d / b.double().norm(dim=-1).clamp(min=1e-30)).max())


def judge(cfg: dict, weights: dict, batch, kept: dict) -> dict:
    """grad_rel: the program's masked gradient against the reference's at
    the program's delta; step_rel: the program's step (next delta less
    this one) against the reference's Adam step, budget and projection from
    the program's state; out_abs: the largest difference of the returned
    marked audio from the reference's output of the last step."""
    prec = precision.get(cfg["precision"])
    precision.no_tf32()
    emb = ref_sem.Embed(ref_codec.Codec(weights, cfg["codec"], prec), cfg["semantic"], batch)
    worst = {"grad_rel": 0.0, "step_rel": 0.0}
    t0 = time.perf_counter()
    for k, s in sorted(kept.items()):
        try:
            g = emb.grad(s["delta"])
            worst["grad_rel"] = max(worst["grad_rel"], _rel(s["grad"], g))
            m = s["m"] if s["m"] is not None else torch.zeros_like(g)
            v = s["v"] if s["v"] is not None else torch.zeros_like(g)
            nxt = emb.after_step(s["delta"], s["grad"], m, v, s["t"], k)
            if "after" in s:
                worst["step_rel"] = max(worst["step_rel"],
                                        _rel(s["after"] - s["delta"], nxt - s["delta"]))
            if "out" in s:
                worst["out_abs"] = float((s["out"] - emb.output(nxt)).abs().max())
        except (RuntimeError, ValueError, KeyError):
            worst = {key: math.inf for key in ("grad_rel", "step_rel", "out_abs")}
            break
    worst = {key: (val if not math.isnan(val) else math.inf) for key, val in worst.items()}
    print(f"port_bench: reference {time.perf_counter() - t0:.2f} s for steps {sorted(kept)}",
          file=sys.stderr)
    return worst
