"""Flowtron training, one step after the other.

The cell's ``params``: ``batch``, ``t_in``, ``t_out`` (the padded batch's
shape) and ``pool`` (distinct batches the feed cycles through); sigma, the
learning rate, the clip and the L2 weight are the configuration's.

A batch is ``train_cycle.make_batch``'s (``cli/bench.py``'s LJSpeech-like
batch) with ids drawn from the configuration's ``n_text`` symbols: ragged
text and mel lengths with the first row at full length, log-mel-like
values zeroed past each length, gate targets 1 from each last frame on;
every row is speaker 0 (one speaker). Each pool batch is drawn from its
own seed; the dropout generator (the encoder's, the step's only draws) is
seeded from the seed.

Set-up builds the training state from the seed (``reference.flowtron``'s
weights) and drives it through the first two steps with the window's own
calls and feed; the check holds those two steps against the reference,
which starts from the seed: each step's loss, each leaf's first gradient
as Adam took it (from its first step) and each leaf's change over the two
steps. It holds one step of the window the same way (the ``window_``
numbers): the first step to start after a time drawn from the seed in the
window's first three fifths, whose starting state (the model, its Adam
state and the dropout generator's state) is copied to the host before it
runs, and which the reference follows from that copy with the same batch.

In a traced run every step runs inside the program's ``tracing()``; the
last one's ``summary()`` (its spans' device seconds and its counters) is
what the per-layer metrics read, with ``spans["flowtron.step"]``: the
device seconds of each traced window step's ``flowtron.step`` span (its
CUDA events), in the order the steps ran.
"""

import contextlib
import time

import numpy as np
import torch

from perfbench import seeds
from perfbench.counts import flowtron as counts
from perfbench.laps import Laps
from perfbench.reference import flowtron as ref
from perfbench.reference.optim import B1, Adam
from perfbench.reference.precision import Precision
from perfbench.traffic.train_cycle import (changes, dropout_seed, first_grads,
                                           hold_after, host, kept_rows,
                                           leaf_gaps, make_batch)

# The number of set-up steps that the check holds.
SETUP_STEPS = 2


def pool_batch(m, p, seed, j, device):
    """Pool batch ``j``: (text, text_lengths, mels, gate, output_lengths,
    speaker_ids) on ``device``."""
    arrays = make_batch({"n_symbols": m["n_text"],
                         "n_mel_channels": m["n_mel_channels"]},
                        seeds.derive32(seed, "batch", j), p["batch"],
                        p["t_in"], p["t_out"])
    out = [torch.from_numpy(a).to(device) for a in arrays]
    return out + [torch.zeros(p["batch"], dtype=torch.long, device=device)]


class Traffic:
    def __init__(self, cell, cfg, seed, device, trace, seconds):
        self.cfg, self.seed = cfg, seed
        self.device, self.trace = device, trace
        self.params, self.m = cell["params"], cfg["model"]
        self.spans = {"flowtron.step": []}
        self.count = dict(steps=0, failed=0, flops=0)
        self.window_start = None
        self.hold_after = hold_after(seed, seconds)
        self.t0 = None
        self.last_unit = {}

    def setup(self, program):
        m, p, dev = self.m, self.params, self.device
        self.program = program
        lap = Laps(dev)
        g = torch.Generator(device=dev).manual_seed(
            seeds.derive(self.seed, "weights"))
        W = ref.weights(m, g, dev)
        lap("weights")
        self.pool = [pool_batch(m, p, self.seed, j, dev)
                     for j in range(int(p["pool"]))]
        lap("batches")
        self.trainer = program.Trainer(self.cfg, W, dev,
                                       dropout_seed(self.seed))
        del W
        lap("program")
        self.at = 0
        self.readings = self._first_steps()
        lap("first_steps")
        self.setup_parts = lap.parts
        # Each pool batch's step, its LSTMs over the batch's valid frames.
        self.step_flops = [
            counts.step_flops(m, p["batch"], p["t_in"], p["t_out"],
                              int(batch[4].sum()))
            for batch in self.pool]

    def _batch(self):
        batch = self.pool[self.at % len(self.pool)]
        self.at += 1
        return batch

    def _first_steps(self):
        """The first steps through the window's calls, with what the check
        reads of them: the losses, each leaf's first gradient as Adam took
        it (its first moment over 1 - beta1 after one update) and each
        leaf's change over the steps."""
        t = self.trainer
        p0 = {n: x.detach().clone() for n, x in t.params()}
        losses = [float(t.step(self._batch()))]
        first = {n: float(x.norm()) / (1 - B1) for n, x in t.first_moments()}
        for _ in range(SETUP_STEPS - 1):
            losses.append(float(t.step(self._batch())))
        change = {n: float((x.detach() - p0[n]).norm())
                  for n, x in t.params()}
        return dict(losses=losses, first=first, change=change)

    def _start(self):
        """The training state as a window step starts, on the host."""
        t = self.trainer
        return dict(state=host(t.state_items()), mu=host(t.first_moments()),
                    nu=host(t.second_moments()), count=t.count(),
                    dropout=t.dropout_state(), at=self.at)

    def unit(self):
        """One training step; waits for its loss. The check's held step
        also copies to the host its starting state and what the check
        reads of it."""
        t = self.trainer
        now = time.perf_counter()
        self.t0 = now if self.t0 is None else self.t0
        held = self.window_start is None and now - self.t0 >= self.hold_after
        if held:
            start = self._start()
        flops = self.step_flops[self.at % len(self.pool)]
        with (self.program.tracing() if self.trace
              else contextlib.nullcontext()):
            loss = t.step(self._batch())
        if self.trace:
            self.last_unit = self.program.summary()
            step = self.last_unit.get("spans", {}).get("flowtron.step")
            if step and step["device_s"] is not None:
                self.spans["flowtron.step"].append(step["device_s"])
        if held:
            start.update(losses=[float(loss)],
                         mu_after=host(t.first_moments()),
                         after=host(t.params()))
            self.window_start = start
        ok = bool(torch.isfinite(loss))
        self.count["steps"] += 1
        self.count["failed"] += 0 if ok else 1
        self.count["flops"] += flops

    def end_to_end(self, window_s):
        """None of its own: the rate is per-layer (``steps_per_s.flowtron``)."""
        return {}

    def attempted_failed(self):
        return self.count["steps"], self.count["failed"]

    def release(self):
        self.trainer = None
        self.pool = None

    # -- the check -----------------------------------------------------------
    def check(self):
        """The program's first steps against the reference's from the seed,
        and the window's held step against the reference's from the state
        it started in. A held step that the window did not reach reads 1."""
        first = reference_steps(self.cfg, self.params, self.seed,
                                self.device)
        gaps = compare(self.readings, first)
        if self.window_start is None:
            window, held = dict.fromkeys(gaps, 1.0), None
        else:
            held = reference_steps(self.cfg, self.params, self.seed,
                                   self.device, start=self.window_start)
            window = compare(held_readings(self.window_start), held)
        self.refs = first, held
        gaps.update({"window_" + k: v for k, v in window.items()})
        return gaps

    def controls(self, controls, faults=()):
        """After ``check``: {name: gaps} of each control (the reference in
        the lower precision ``{"all": ...}`` put in the program's place)
        and each fault of the reference ("half_batch"), against the float32
        reference, over the first steps and the window's held one."""
        if self.window_start is None:
            raise RuntimeError("the window ran no held step")
        sides = [(n, c["all"], None) for n, c in controls.items()]
        sides += [(f, "float32", f) for f in faults]
        out = {}
        for name, prec, fault in sides:
            gaps = compare(reference_steps(
                self.cfg, self.params, self.seed, self.device,
                Precision(prec), fault), self.refs[0])
            got = reference_steps(self.cfg, self.params, self.seed,
                                  self.device, Precision(prec), fault,
                                  start=self.window_start)
            gaps.update({"window_" + k: v
                         for k, v in compare(got, self.refs[1]).items()})
            out[name] = gaps
        return out


def held_readings(c):
    """What the check reads of the window's held step, from the host
    copies that ``Traffic.unit`` took of it."""
    return dict(losses=c["losses"], first=first_grads(c["mu"],
                                                      c["mu_after"]),
                change=changes(c["state"], c["after"]))


def compare(got, ref_):
    """The gaps of the program's steps from the reference's. ``loss_gap``:
    the largest |loss - reference's| over the reference's loss.
    ``grad_gap``: the worst leaf's |norm - reference norm| of the first
    gradient, over the larger of the leaf's reference norm and the median
    leaf's. ``change_gap``: the median leaf's gap of the change, taken the
    same way, over the leaves whose reference first gradient is at least a
    thousandth of the median leaf's (below that is rounding, as the
    encoder's conv biases before a batch-statistics BatchNorm: Adam moves
    them by the learning rate whatever it is; ``train_cycle.compare`` says
    why the median)."""
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(got["losses"], ref_["losses"]))
    first = ref_["first"]
    grad_gap = max(leaf_gaps(got["first"], first, first))
    med = float(np.median(list(first.values())))
    keep = [n for n, f in first.items() if f >= 1e-3 * med]
    change_gap = float(np.median(leaf_gaps(got["change"], ref_["change"],
                                           keep)))
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap}


def reference_steps(cfg, p, seed, device, P_=Precision(), fault=None,
                    start=None):
    """Steps of the plain reference: the set-up's first ones, from the
    seed's weights, a fresh optimizer and the seeded dropout stream; or,
    with ``start`` (``Traffic._start``'s copy), the window's held step from
    the state that it started in. The batches are the seed's, at the
    steps' place in the feed. ``fault``: "half_batch" takes each step over
    the first half of its rows (the mean over those), for the check's
    fault readings."""
    m = cfg["model"]
    drop = torch.Generator(device=device)
    if start is None:
        g = torch.Generator(device=device).manual_seed(
            seeds.derive(seed, "weights"))
        W = ref.weights(m, g, device)
        drop.manual_seed(dropout_seed(seed))
        at, n_steps = 0, SETUP_STEPS
    else:
        W = {n: x.to(device, copy=True) for n, x in start["state"].items()}
        drop.set_state(start["dropout"])
        at, n_steps = start["at"], 1
    trainable = [n for n in W if not n.endswith(("running_mean",
                                                 "running_var"))]
    params = [W[n].requires_grad_() for n in trainable]
    p0 = [x.detach().clone() for x in params]
    opt = Adam(params, m["grad_clip_val"], m["weight_decay"])
    if start is not None:
        opt.resume(start["count"], [start["mu"][n] for n in trainable],
                   [start["nu"][n] for n in trainable])
    rows = kept_rows(p["batch"], 1, fault).to(device)
    losses, first = [], None
    for j in range(n_steps):
        text, tl, mels, gate, ol, spk = [
            x[rows] for x in pool_batch(m, p, seed, (at + j) % int(p["pool"]),
                                        device)]
        out = ref.forward_train(W, m, text, tl, mels, ol, spk, drop, P_)
        total = ref.loss(out, gate, ol, m["sigma"])
        del out
        took = opt.step(params, torch.autograd.grad(total, params),
                        m["learning_rate"])
        if first is None:
            first = {n: float(x.norm()) for n, x in zip(trainable, took)}
        losses.append(float(total.detach()))
    return dict(losses=losses, first=first, dropout_state=drop.get_state(),
                change={n: float((x.detach() - y).norm())
                        for n, x, y in zip(trainable, params, p0)})
