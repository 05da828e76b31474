"""The check that decides ``correct``, at tiny widths on the CPU.

A whole run (set-up, window, check) of each one-card cell minus the
harness's look for a card (the cells on more than one card:
``test_perfbench_group.py``):
sound, it comes out correct; with the timed path broken underneath (a
step that returns its state unchanged, half of the batch left out, an
answer altered where it is produced) it comes out not correct; and the
control, the reference put in the program's place one precision lower,
fails the cell's limits. The limits are the committed ones."""

import types

import pytest
import torch

from perfbench import harness
from perfbench.tests.tiny import adapter, cells, tiny

CPU = torch.device("cpu")
SEED = 2 ** 31 + 99
# Tiny sizes of each traffic kind's parameters.
TINY = {"synth_batch": dict(batch=8, max_frames=30, check_requests=6),
        "train_cycle": dict(batch=4, t_in=10, t_out=24)}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_cell(cell_name):
    entry = tiny(cell_name)[0]
    return tiny(cell_name, **TINY[entry["traffic"]])


def run(cell_name, seconds=0.5):
    entry, cell, cfg, manifest = tiny_cell(cell_name)
    args = types.SimpleNamespace(workload=cell_name, seed=SEED,
                                 seconds=seconds, trace=0)
    return harness.measure(args, entry, cell, cfg, manifest, CPU,
                           adapter(cfg))


@pytest.mark.parametrize("cell", cells(chips=1))
def test_a_sound_run_is_correct(cell):
    r = run(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0


# -- the draws that the reference repeats -----------------------------------
DRAWS = ("the benchmark's reference repeats the program's dropout draws "
         "from the generator that the program is handed ({}); the program "
         "now draws otherwise, so every run of this cell would read "
         "correct false, sound or not. Hand the masks to both sides (a "
         "benchmark change) before changing how the program draws them.")


@pytest.mark.parametrize("cell", cells("synth_batch"))
def test_the_prenet_draws_are_those_the_reference_repeats(cell):
    entry, c, cfg, manifest = tiny_cell(cell)
    m = cfg["model"]
    kind = harness.load_module("traffic", c["traffic"])
    traffic = kind.Traffic(c, cfg, SEED, CPU, False, 0.5)
    traffic.setup(adapter(cfg))
    B, S = 3, 7
    g = torch.Generator().manual_seed(5)
    ids = torch.randint(1, 40, (B, 6), generator=g)
    style = torch.rand((B, 1, m["noise_size"]), generator=g)
    speaker = torch.tensor([0, 1, 2]) if m["vesus"] else None
    emotions = torch.rand((B, m["n_labels"]), generator=g) \
        if m["vesus"] else None
    got = torch.Generator().manual_seed(11)
    traffic.model.infer(ids, style=style if m["use_noise"] else None,
                        emotions=emotions, speaker=speaker, max_steps=S,
                        early_exit=False, text_lengths=torch.full((B,), 6),
                        generator=got)
    want = torch.Generator().manual_seed(11)
    for _ in range(2 * S):
        torch.rand((B, m["prenet_dim"]), generator=want)
    assert torch.equal(got.get_state(), want.get_state()), DRAWS.format(
        "Tacotron2.infer: two (B, prenet_dim) uniform draws a decoder "
        "step, the prenet's layers in order")


@pytest.mark.parametrize("cell", cells("train_cycle"))
def test_the_training_draws_are_those_the_reference_repeats(cell):
    entry, c, cfg, manifest = tiny_cell(cell)
    kind = harness.load_module("traffic", c["traffic"])
    traffic = kind.Traffic(c, cfg, SEED, CPU, False, 0.5)
    traffic.setup(adapter(cfg))  # drives the first G/G/D cycle
    ref = kind.reference_cycle(cfg, c["params"], SEED, CPU)
    assert torch.equal(traffic.trainer.dropout_state(),
                       ref["dropout_state"]), DRAWS.format(
        "the G and D steps: every dropout of the teacher-forced pass and of "
        "the discriminator, layer by layer in the reference's order")


# -- faults of the synthesis path -------------------------------------------
def altered_frame(monkeypatch):
    """One decoder frame changed where the step makes it (and fed back)."""
    from gantron_tpu_torch.models.tacotron2 import Decoder

    step = Decoder._open_step

    def broken(self, carry, *a, **k):
        (state, mel_t, fin, length, t), (mel_rec, gate, attn) = step(
            self, carry, *a, **k)
        if t == 4:
            mel_t = mel_t + 0.05
            mel_rec = mel_rec + 0.05
        return (state, mel_t, fin, length, t), (mel_rec, gate, attn)

    monkeypatch.setattr(Decoder, "_open_step", broken)


def unchanged_state(monkeypatch):
    """The decoder step returns the state it was given."""
    from gantron_tpu_torch.models.tacotron2 import Decoder

    monkeypatch.setattr(Decoder, "_step_core",
                        lambda self, state, *a, **k: state)


def half_batch_synth(monkeypatch):
    """Only the first half of the batch decoded; the rest left zero."""
    from gantron_tpu_torch.models.tacotron2 import Tacotron2

    infer = Tacotron2.infer

    def broken(self, text, style=None, emotions=None, speaker=None,
               text_lengths=None, **k):
        h = text.shape[0] // 2
        cut = [x[:h] if x is not None else None
               for x in (text, style, emotions, speaker, text_lengths)]
        out = infer(self, cut[0], style=cut[1], emotions=cut[2],
                    speaker=cut[3], text_lengths=cut[4], **k)
        return [torch.cat([o, torch.zeros((text.shape[0] - h,)
                                          + o.shape[1:], dtype=o.dtype)])
                for o in out]

    monkeypatch.setattr(Tacotron2, "infer", broken)


SYNTH_FAULTS = [altered_frame, unchanged_state, half_batch_synth]


@pytest.mark.parametrize("fault", SYNTH_FAULTS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", cells("synth_batch"))
def test_a_broken_synthesis_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    assert not run(cell)["correct"]


# -- faults of the training path --------------------------------------------
def unchanged_train_state(monkeypatch):
    """Every optimizer update returns the state it was given and leaves the
    parameters as they were."""
    from gantron_tpu_torch.train import state as st

    make = st.make_optimizer

    def broken(*a, **k):
        opt = make(*a, **k)
        return st.Optimizer(opt.init, lambda grads, s, params, lr: s)

    monkeypatch.setattr(st, "make_optimizer", broken)


def half_batch_train(monkeypatch):
    """Each step takes the first half of its batch's rows, the mean over
    those."""
    from gantron_tpu_torch.train import step as st

    make = st.make_train_steps

    def broken(*a, **k):
        g_step, d_step, eval_step = make(*a, **k)

        def g(state, batch, *args, style=None, **kw):
            h = batch.text.shape[0] // 2
            return g_step(state, st.Batch(*(x[:h] for x in batch)), *args,
                          style=None if style is None else style[:h], **kw)

        def d(state, real, real_l, gen, gen_l, lr):
            h = real.shape[0] // 2
            return d_step(state, real[:h], real_l[:h], gen[:h], gen_l[:h],
                          lr)

        return g, d, eval_step

    monkeypatch.setattr(st, "make_train_steps", broken)


def half_batch_after_setup(monkeypatch):
    """Sound through set-up's first cycle; from the window's first cycle
    on, each step takes the first half of its batch's rows (a fault that
    only later steps have, as a recompilation or a captured graph might)."""
    from gantron_tpu_torch.train import step as st

    make = st.make_train_steps

    def broken(*a, **k):
        g_step, d_step, eval_step = make(*a, **k)
        calls = {"g": 0, "d": 0}

        def g(state, batch, *args, style=None, **kw):
            calls["g"] += 1
            if calls["g"] <= 2:
                return g_step(state, batch, *args, style=style, **kw)
            h = batch.text.shape[0] // 2
            return g_step(state, st.Batch(*(x[:h] for x in batch)), *args,
                          style=None if style is None else style[:h], **kw)

        def d(state, real, real_l, gen, gen_l, lr):
            calls["d"] += 1
            h = real.shape[0] // (1 if calls["d"] <= 1 else 2)
            return d_step(state, real[:h], real_l[:h], gen[:h], gen_l[:h],
                          lr)

        return g, d, eval_step

    monkeypatch.setattr(st, "make_train_steps", broken)


@pytest.mark.parametrize("fault", [unchanged_train_state, half_batch_train,
                                   half_batch_after_setup],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", cells("train_cycle"))
def test_a_broken_training_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    assert not run(cell)["correct"]


# -- the controls -----------------------------------------------------------
def control_cases():
    """(cell, control) of every control that a cell's file names."""
    return [(c, name) for c in cells(chips=1)
            for name in tiny(c)[1]["controls"]]


@pytest.mark.parametrize("cell,control", control_cases(),
                         ids=[f"{c}-{n}" for c, n in control_cases()])
def test_each_control_fails_the_limits(cell, control):
    entry, c, cfg, manifest = tiny_cell(cell)
    kind = harness.load_module("traffic", c["traffic"])
    traffic = kind.Traffic(c, cfg, SEED, CPU, False, 0.0)
    traffic.setup(adapter(cfg))
    for _ in range(3):
        traffic.unit()
    traffic.release()
    traffic.check()
    gaps = traffic.controls({control: c["controls"][control]})[control]
    _, ok = harness.read_checks(gaps, c["limits"])
    assert not ok, gaps


@pytest.mark.parametrize("cell", cells("train_cycle"))
def test_the_held_cycle_is_drawn_from_the_seed_inside_the_window(cell):
    kind = harness.load_module("traffic", tiny_cell(cell)[1]["traffic"])
    at = [kind.hold_after(SEED + j, 51) for j in range(200)]
    assert at == [kind.hold_after(SEED + j, 51) for j in range(200)]
    assert 0 <= min(at) < 3 and 27 < max(at) < 0.6 * 51
    r = run(cell, seconds=2.0)
    assert r["correct"], r["checks"]
    assert r["checks"]["window_loss_gap"]["value"] < 1.0
