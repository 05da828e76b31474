"""GAN training in G/G/D cycles, one step after the other.

The cell's ``params``: ``batch``, ``t_in``, ``t_out`` (the padded batch's
shape), ``attn_weight`` (the attention guide's weight) and ``pool``
(distinct batches the feed cycles through).

A batch is ``cli/bench.py``'s synthetic LJSpeech-like batch (copied here
as ``make_batch``): random ids with no padding symbol, ragged text and mel
lengths with the first row at full length, log-mel-like values zeroed past
each length, gate targets 1 from each last frame on. Each pool batch is
drawn from its own seed; each G step draws its style noise from the seed;
the dropout generator is seeded from the seed.

Set-up builds the training state from the seed and drives it through the
first cycle (G, G, D) with the window's own calls and feed; the check
holds those three steps against the reference, which starts from the
seed: each step's loss, each leaf's first gradient as Adam took it (G from
its first step, D from its step), and each leaf's change over the three
steps. It holds one cycle of the window the same way (the ``window_``
numbers): the first cycle to start after a time drawn from the seed in
the window's first three fifths, whose starting state (both networks, both Adam states and the dropout
generator's state) is copied to the host before it runs, and which the
reference follows from that copy with the same batches and style draws.
"""

import time

import numpy as np
import torch

from perfbench import seeds, weights
from perfbench.laps import Laps
from perfbench.counts import flops
from perfbench.reference import discriminator as ref_d
from perfbench.reference import tacotron2 as ref_taco
from perfbench.reference.optim import B1, Adam
from perfbench.reference.precision import Precision


def make_batch(m, seed, B, T_in, T_out):
    """``cli/bench.py``'s batch, draw for draw from ``RandomState(seed)``:
    (text, text_lengths, mels, gate, output_lengths) as numpy arrays."""
    rng = np.random.RandomState(seed)
    text = rng.randint(1, m["n_symbols"], (B, T_in)).astype(np.int64)
    text_lengths = rng.randint(T_in // 2, T_in + 1, B).astype(np.int64)
    text_lengths[0] = T_in
    mels = (rng.randn(B, m["n_mel_channels"], T_out) * 1.5 - 6).astype(
        np.float32)
    output_lengths = rng.randint(T_out // 2, T_out + 1, B).astype(np.int64)
    output_lengths[0] = T_out
    gate = np.zeros((B, T_out), np.float32)
    for b in range(B):
        mels[b, :, output_lengths[b]:] = 0
        gate[b, output_lengths[b] - 1:] = 1
    return text, text_lengths, mels, gate, output_lengths


def pool_batch(m, p, seed, j, device):
    arrays = make_batch(m, seeds.derive32(seed, "batch", j), p["batch"],
                        p["t_in"], p["t_out"])
    return [torch.from_numpy(a).to(device) for a in arrays]


def step_style(m, seed, step, batch, device):
    """The style noise (B, 1, noise_size) of G step ``step``."""
    g = torch.Generator(device=device).manual_seed(
        seeds.derive(seed, "style", step))
    return torch.rand((batch, 1, m["noise_size"]), generator=g, device=device)


def dropout_seed(seed, rank=None):
    """The dropout generator's seed; in a data-parallel group, each rank's."""
    if rank is None:
        return seeds.derive(seed, "dropout")
    return seeds.derive(seed, "dropout", rank)


def dropout_generators(seed, ranks, device, states=None):
    """The dropout stream that the reference draws from: one generator, or
    with ``ranks`` over 1 a list of the ranks' (``reference.tacotron2``'s
    ``uniform``); seeded from the seed, or set to ``states`` (a state, or
    the ranks' list)."""
    gens = [torch.Generator(device=device) for _ in range(ranks)]
    for r, g in enumerate(gens):
        if states is not None:
            g.set_state(states if ranks == 1 else states[r])
        else:
            g.manual_seed(dropout_seed(seed, None if ranks == 1 else r))
    return gens[0] if ranks == 1 else gens


def kept_rows(rows, ranks, fault):
    """The global batch's rows that a cycle steps on: all of them, or with
    ``fault`` "half_batch" the first half of each rank's share."""
    n = rows // ranks
    take = n // 2 if fault == "half_batch" else n
    return torch.cat([torch.arange(r * n, r * n + take)
                      for r in range(ranks)])


def hold_after(seed, seconds):
    """Seconds into the window from which the next cycle to start is the
    one that the check holds: drawn from the seed over the window's first
    three fifths, so that the cycle starts, and ends, inside a window of
    ``seconds`` whose cycles each take under two fifths of it."""
    return seeds.derive(seed, "held_cycle") / 2 ** 63 * 0.6 * seconds


def host(tensors):
    """{name: a host copy} of (name, device tensor) pairs."""
    return {n: x.detach().to("cpu", copy=True) for n, x in tensors}


def first_grads(mu_before, mu_after):
    """Each leaf's norm of the gradient that Adam's first moment took,
    (mu_after - B1 mu_before) / (1 - B1), in float64 on the host."""
    return {n: float(((mu_after[n].double() - B1 * mu_before[n].double())
                      / (1 - B1)).norm()) for n in mu_after}


def changes(before, after):
    return {n: float((after[n].double() - before[n].double()).norm())
            for n in after}


def held_readings(c):
    """What the check reads of the window's held cycle, from the host
    copies that ``Traffic.unit`` took of it: as ``_first_cycle`` reads the
    first cycle."""
    return dict(losses=c["losses"],
                g_first=first_grads(c["g_mu"], c["g_mu_after"]),
                d_first=first_grads(c["d_mu"], c["d_mu_after"]),
                g_change=changes(c["g"], c["g_after"]),
                d_change=changes(c["d"], c["d_after"]))


class Traffic:
    # The data-parallel ranks whose dropout streams the reference repeats.
    ranks = 1

    def __init__(self, cell, cfg, seed, device, trace, seconds):
        self.cfg, self.seed = cfg, seed
        self.device, self.trace = device, trace
        self.params, self.m = cell["params"], cfg["model"]
        self.spans = {"g_step": [], "d_step": []}
        self.count = dict(steps=0, cycles=0, failed=0, flops=0)
        self.g_steps = 0
        self.window_start = None
        self.hold_after = hold_after(seed, seconds)
        self.t0 = None

    def setup(self, program):
        m, p, dev = self.m, self.params, self.device
        lap = Laps(dev)
        g = torch.Generator(device=dev).manual_seed(
            seeds.derive(self.seed, "weights"))
        W = weights.tacotron2(m, g, dev)
        Wd = weights.discriminator(m, g, dev)
        lap("weights")
        self.pool = [[self._local(x) for x in pool_batch(m, p, self.seed, j,
                                                          dev)]
                     for j in range(int(p["pool"]))]
        lap("batches")
        self.trainer = program.Trainer(self.cfg, W, Wd, dev,
                                       self._dropout_seed())
        del W, Wd
        lap("program")
        self.at = 0
        self.readings = self._first_cycle()
        lap("first_cycle")
        self.setup_parts = lap.parts
        self.cycle_flops = flops.train_cycle_flops(m, p["batch"], p["t_in"],
                                                   p["t_out"])

    def _batches(self):
        a = self.pool[self.at % len(self.pool)]
        b = self.pool[(self.at + 1) % len(self.pool)]
        self.at += 2
        return a, b

    def _local(self, x):
        """This process's rows of a tensor of the global batch: all."""
        return x

    def _dropout_seed(self):
        return dropout_seed(self.seed)

    def _holds(self, now):
        """Whether the cycle that starts ``now`` is the check's held one."""
        return (self.window_start is None
                and now - self.t0 >= self.hold_after)

    def _g(self, batch):
        style = self._local(step_style(self.m, self.seed, self.g_steps,
                                       self.params["batch"], self.device))
        self.g_steps += 1
        return self.trainer.g_step(batch, style, self.params["attn_weight"])

    def _first_cycle(self):
        """The first G/G/D cycle through the window's calls, with what the
        check reads of it: the losses, each leaf's first gradient as Adam
        took it (its first moment over 1 - beta1 after one update) and each
        leaf's change over the three steps."""
        t = self.trainer
        g0 = {n: x.detach().clone() for n, x in t.g_params()}
        d0 = {n: x.detach().clone() for n, x in t.d_params()}
        a, b = self._batches()
        loss1, _ = self._g(a)
        g_first = {n: float(x.norm()) / (1 - B1)
                   for n, x in t.g_first_moments()}
        loss2, fake = self._g(b)
        loss3 = t.d_step(b, fake, parts=True)
        d_first = {n: float(x.norm()) / (1 - B1)
                   for n, x in t.d_first_moments()}
        g_change = {n: float((x.detach() - g0[n]).norm())
                    for n, x in t.g_params()}
        d_change = {n: float((x.detach() - d0[n]).norm())
                    for n, x in t.d_params()}
        del g0, d0
        losses = [float(loss1), float(loss2)] + [float(x) for x in loss3]
        return dict(losses=losses, g_first=g_first, d_first=d_first,
                    g_change=g_change, d_change=d_change)

    def _start(self):
        """The training state as a window cycle starts, on the host."""
        t = self.trainer
        return dict(
            g=host(t.g_state()), d=host(t.d_state()),
            g_mu=host(t.g_first_moments()), g_nu=host(t.g_second_moments()),
            d_mu=host(t.d_first_moments()), d_nu=host(t.d_second_moments()),
            g_count=t.g_count(), d_count=t.d_count(),
            dropout=t.dropout_state(), at=self.at, g_steps=self.g_steps)

    def unit(self):
        """One G/G/D cycle; waits for its last loss. The check's held cycle
        also copies to the host its starting state and, as it goes, what
        the check reads of it; the check works the readings out after the
        window, and the host spans leave this cycle out."""
        tr = self.trainer
        now = time.perf_counter()
        self.t0 = now if self.t0 is None else self.t0
        held = self._holds(now)
        if held:
            start = self._start()
        a, b = self._batches()
        t0 = self._clock()
        loss_1, _ = self._g(a)
        if held:
            start["g_mu_after"] = host(tr.g_first_moments())
        t1 = self._clock()
        loss_g, fake = self._g(b)
        t2 = self._clock()
        loss_d = tr.d_step(b, fake, parts=held)
        if held:
            start.update(
                losses=[float(loss_1), float(loss_g)]
                + [float(x) for x in loss_d],
                d_mu_after=host(tr.d_first_moments()),
                g_after=host(tr.g_params()), d_after=host(tr.d_params()))
            loss_d = loss_d[0] + loss_d[1]
            self.window_start = start
        ok = bool(torch.isfinite(loss_g) & torch.isfinite(loss_d))
        t3 = time.perf_counter()
        if self.trace and not held:
            self.spans["g_step"] += [(t1 - t0, 1), (t2 - t1, 1)]
            self.spans["d_step"].append((t3 - t2, 1))
        self.count["steps"] += 3
        self.count["cycles"] += 1
        self.count["failed"] += 0 if ok else 3
        self.count["flops"] += self.cycle_flops

    def _clock(self):
        if self.trace and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def end_to_end(self, window_s):
        """None of its own: the rate is per-layer (``steps_per_s.train``)."""
        return {}

    def attempted_failed(self):
        return self.count["steps"], self.count["failed"]

    def release(self):
        self.trainer = None
        self.pool = None

    # -- the check -----------------------------------------------------------
    def check(self):
        """The program's first cycle against the reference's from the seed,
        and the window's held cycle against the reference's from the state
        it started in. A held cycle that the window did not reach reads 1."""
        ref = reference_cycle(self.cfg, self.params, self.seed, self.device,
                              ranks=self.ranks)
        self.look = worst_leaves(self.readings, ref)
        gaps = compare(self.readings, ref)
        if self.window_start is None:
            window, ref_w = dict.fromkeys(gaps, 1.0), None
        else:
            ref_w = reference_cycle(self.cfg, self.params, self.seed,
                                    self.device, start=self.window_start,
                                    ranks=self.ranks)
            window = compare(held_readings(self.window_start), ref_w)
        self.refs = ref, ref_w
        gaps.update({"window_" + k: v for k, v in window.items()})
        return gaps

    def controls(self, controls, faults=()):
        """After ``check``: {name: gaps} of each control (the reference in
        the lower precision ``{"all": ...}`` put in the program's place)
        and each planted fault ("half_batch"), against the float32
        reference, over the first cycle and the window's held one."""
        if self.window_start is None:
            raise RuntimeError("the window ran no held cycle")
        sides = [(n, c["all"], None) for n, c in controls.items()]
        sides += [(f, "float32", f) for f in faults]
        out = {}
        for name, prec, fault in sides:
            gaps = compare(reference_cycle(
                self.cfg, self.params, self.seed, self.device,
                Precision(prec), fault, ranks=self.ranks), self.refs[0])
            got = reference_cycle(self.cfg, self.params, self.seed,
                                  self.device, Precision(prec), fault,
                                  start=self.window_start, ranks=self.ranks)
            gaps.update({"window_" + k: v
                         for k, v in compare(got, self.refs[1]).items()})
            out[name] = gaps
        return out


def worst_leaves(got, ref):
    """Each leaf's gap of the first gradient and of the change (as
    ``compare`` takes them), largest first: what calibration looks at."""
    out = {}
    for kind in ("first", "change"):
        rows = []
        for side in ("g", "d"):
            ys = ref[f"{side}_{kind}"]
            med = float(np.median(list(ys.values())))
            first = ref[f"{side}_first"]
            fmed = float(np.median(list(first.values())))
            for n, y in ys.items():
                rows.append((abs(got[f"{side}_{kind}"][n] - y) / max(y, med),
                             f"{side.upper()} {n}", y, first[n] / fmed))
        out[kind] = sorted(rows, reverse=True)[:6]
    out["losses"] = [(a, b) for a, b in zip(got["losses"], ref["losses"])]
    out["change_worst"] = max(max(leaf_gaps(
        got[s + "_change"], ref[s + "_change"],
        [n for n, f in ref[s + "_first"].items()
         if f >= 1e-3 * float(np.median(list(ref[s + "_first"].values())))]))
        for s in ("g", "d"))
    return out


def compare(got, ref):
    """The gaps of the program's first cycle from the reference's.
    ``loss_gap``: the largest |loss - reference's| of the three steps,
    over the reference's loss; the D step's loss taken in its two terms
    (the real and the generated mels' scores: their difference, the loss,
    is near 0 and would scale the gap up by the cancellation), each over
    the larger of the two terms' magnitudes (either score alone may pass
    through 0 as D trains). ``grad_gap``: the worst
    leaf's |norm - reference norm| of the first gradient, over the larger
    of the leaf's reference norm and the median leaf's (G and D).
    ``change_gap``: the median leaf's gap of the change over the three
    steps, taken the same way, over the leaves whose reference first
    gradient is at least a thousandth of the median leaf's (a gradient
    below that is rounding, such as a conv bias before a batch-statistics
    BatchNorm, and Adam moves it by the learning rate whatever it is). The
    median, not the worst leaf: Adam divides each element's gradient by its
    own root mean square, so an element whose gradient sums to near 0
    moves by up to the learning rate on its rounding alone, and the worst
    leaf's change reads that (the encoder's BatchNorm leaves, PERF.md)."""
    g_ref, d_ref = ref["losses"][:2], ref["losses"][2:]
    scale = [abs(b) for b in g_ref] + [max(abs(b) for b in d_ref)] * 2
    loss_gap = max(abs(a - b) / c
                   for a, b, c in zip(got["losses"], ref["losses"], scale))
    grad_gap = max(max(leaf_gaps(got[s + "_first"], ref[s + "_first"],
                                 ref[s + "_first"])) for s in ("g", "d"))
    change = []
    for side in ("g", "d"):
        first = ref[side + "_first"]
        med = float(np.median(list(first.values())))
        keep = [n for n, f in first.items() if f >= 1e-3 * med]
        change += leaf_gaps(got[side + "_change"], ref[side + "_change"],
                            keep)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": float(np.median(change))}


def leaf_gaps(xs, ys, names):
    """|x - y| / max(y, the median leaf's y) of the named leaves, matched
    by name; a leaf missing on one side is a gap of 1."""
    if set(xs) != set(ys):
        return [1.0]
    med = float(np.median(list(ys.values())))
    return [abs(xs[n] - ys[n]) / max(ys[n], med) for n in names]


def reference_cycle(cfg, p, seed, device, P_=Precision(), fault=None,
                    start=None, ranks=1):
    """One G/G/D cycle in the plain reference: the first, from the seed's
    weights, a fresh optimizer and the seeded dropout stream; or, with
    ``start`` (``Traffic._start``'s copy), a window cycle from the state
    that it started in. The batches and styles are the seed's, at the
    cycle's place in the feed. ``fault``: "half_batch" takes each step
    over the first half of its rows (the mean over the rest), for the
    check's fault readings. ``ranks``: the data-parallel ranks the program
    ran on; the reference steps on the whole global batch at once (its
    BatchNorm statistics, its mean losses and gradients are the global
    batch's, as the ranks' reduced ones are) and draws each rank's rows of
    every dropout from that rank's stream; with "half_batch", each rank's
    first half of its rows."""
    m = cfg["model"]
    if start is None:
        g = torch.Generator(device=device).manual_seed(
            seeds.derive(seed, "weights"))
        W = weights.tacotron2(m, g, device)
        Wd = weights.discriminator(m, g, device)
        drop = dropout_generators(seed, ranks, device)
        at = steps = 0
    else:
        W = {n: x.to(device, copy=True) for n, x in start["g"].items()}
        Wd = {n: x.to(device, copy=True) for n, x in start["d"].items()}
        drop = dropout_generators(seed, ranks, device, start["dropout"])
        at, steps = start["at"], start["g_steps"]
    names, dnames = list(W), list(Wd)
    trainable = [n for n in names if not n.endswith(("running_mean",
                                                     "running_var"))]
    gp = [W[n].requires_grad_() for n in trainable]
    dp = [Wd[n].requires_grad_() for n in dnames]
    g0 = [x.detach().clone() for x in gp]
    d0 = [x.detach().clone() for x in dp]
    g_opt = Adam(gp, m["grad_clip_thresh"], m["weight_decay"])
    d_opt = Adam(dp, m["clipping_value"], m["weight_decay"])
    if start is not None:
        g_opt.resume(start["g_count"], [start["g_mu"][n] for n in trainable],
                     [start["g_nu"][n] for n in trainable])
        d_opt.resume(start["d_count"], [start["d_mu"][n] for n in dnames],
                     [start["d_nu"][n] for n in dnames])
    rows = kept_rows(p["batch"], ranks, fault).to(device)
    batches = [[x[rows] for x in pool_batch(m, p, seed,
                                            (at + j) % int(p["pool"]),
                                            device)]
               for j in range(2)]
    losses = []

    def g_step(batch, step):
        text, tl, mels, gate, ol = batch
        style = step_style(m, seed, step, p["batch"], device)[rows]
        out = ref_taco.forward_train(W, m, text, tl, mels, ol, style, drop,
                                     P_)
        mel_l, gate_l, attn_l = ref_taco.tacotron2_loss(out, mels, gate, tl,
                                                        ol)
        adv = ref_d.loss(Wd, m, out[1], ol, drop, P_=P_)
        total = mel_l + gate_l + adv + p["attn_weight"] * attn_l
        grads = torch.autograd.grad(total, gp)
        took = g_opt.step(gp, grads, m["g_learning_rate"])
        losses.append(float(total.detach()))
        return took, out[1].detach()

    took, _ = g_step(batches[0], steps)
    g_first = {n: float(x.norm()) for n, x in zip(trainable, took)}
    _, fake = g_step(batches[1], steps + 1)
    text, tl, mels, gate, ol = batches[1]
    real = ref_d.loss(Wd, m, mels, ol, drop, P_=P_)
    fake_l = -ref_d.loss(Wd, m, fake, ol, drop, P_=P_)
    d_loss = (real + fake_l) / 2
    took = d_opt.step(dp, torch.autograd.grad(d_loss, dp),
                      m["d_learning_rate"])
    losses += [float(real.detach()), float(fake_l.detach())]
    d_first = {n: float(x.norm()) for n, x in zip(dnames, took)}
    return dict(
        losses=losses, g_first=g_first, d_first=d_first,
        dropout_state=(drop.get_state() if ranks == 1
                       else [d.get_state() for d in drop]),
        g_change={n: float((x.detach() - y).norm())
                  for n, x, y in zip(trainable, gp, g0)},
        d_change={n: float((x.detach() - y).norm())
                  for n, x, y in zip(dnames, dp, d0)})
