"""The Flowtron cell (``flowtron_ljs.train_b64``) at tiny widths on the CPU:
a whole run (set-up, window, check) minus the harness's look for a card.
Sound, it comes out correct and its traced line carries the per-layer
metrics that a CPU run can read; with the timed path broken underneath
(the second flow left in time order, a state left unchanged, half of the
batch left out) it comes out not correct; the control, the reference put
in the program's place one precision lower, and the faults that
calibration reads fail the limits. Besides, the counts are those of the
reference's forward, and a checkout whose program lacks Flowtron fails
the adapter's ``check``. The limits are the committed ones."""

import sys
import types

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import harness, seeds
from perfbench.counts import flowtron as counts
from perfbench.reference import flowtron as ref
from perfbench.tests.tiny import adapter, load, tiny

CELL = "flowtron_ljs.train_b64"
CPU = torch.device("cpu")
SEED = 2 ** 31 + 77
TINY = dict(batch=4, t_in=10, t_out=24)


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(seconds=1.0, trace=0):
    entry, cell, cfg, manifest = tiny(CELL, **TINY)
    args = types.SimpleNamespace(workload=CELL, seed=SEED, seconds=seconds,
                                 trace=trace)
    return harness.measure(args, entry, cell, cfg, manifest, CPU,
                           adapter(cfg))


@pytest.mark.parametrize("trace", [0, 1])
def test_a_sound_run_is_correct(trace):
    r = run(trace=trace)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["checks"]["window_loss_gap"]["value"] < 1.0
    if trace:
        # The spans' device seconds and the idle share need a card.
        assert set(r["metrics"]) == {"steps_per_s.flowtron", "mfu.flowtron"}
    else:
        assert set(r["metrics"]) == {"peak_mem_gib", "setup_s"}


def no_reverse(monkeypatch, request):
    """The adapter's planted fault: the second flow in time order."""
    request.addfinalizer(adapter(tiny(CELL)[2]).plant("no_reverse", 0))


def unchanged_state(monkeypatch, request):
    """Every optimizer update returns the state it was given and leaves the
    parameters as they were."""
    from gantron_tpu_torch.train import state as st

    make = st.make_optimizer

    def broken(*a, **k):
        opt = make(*a, **k)
        return st.Optimizer(opt.init, lambda grads, s, params, lr: s)

    monkeypatch.setattr(st, "make_optimizer", broken)


def half_batch(monkeypatch, request):
    """Each step takes the first half of its batch's rows."""
    from gantron_tpu_torch.train import step as st

    make = st.make_flowtron_step

    def broken(*a, **k):
        step = make(*a, **k)

        def half(state, batch, lr):
            h = batch.text.shape[0] // 2
            return step(state, st.Batch(*(None if x is None else x[:h]
                                          for x in batch)), lr)

        return half

    monkeypatch.setattr(st, "make_flowtron_step", broken)


@pytest.mark.parametrize("fault", [no_reverse, unchanged_state, half_batch],
                         ids=lambda f: f.__name__)
def test_a_broken_training_is_not_correct(fault, monkeypatch, request):
    fault(monkeypatch, request)
    assert not run()["correct"]


def test_the_control_and_the_faults_fail_the_limits():
    from perfbench import calibrate

    entry, cell, cfg, _ = tiny(CELL, **TINY)
    args = types.SimpleNamespace(seeds=1, controls=1, units=5, seconds=1.0,
                                 first_seed=SEED)
    lines = calibrate.readings((args, entry, cell, cfg), CPU, adapter(cfg))
    sides = {r["side"]: r for r in lines if "side" in r}
    assert set(sides) == {"program", "tf32", "half_batch", "no_reverse"}
    for side, r in sides.items():
        gaps = {k: v for k, v in r.items() if k.endswith("_gap")}
        _, ok = harness.read_checks(gaps, cell["limits"])
        assert ok == (side == "program"), (side, gaps)


def test_the_dropout_draws_are_those_the_reference_repeats():
    from perfbench.traffic import flowtron_train

    entry, cell, cfg, _ = tiny(CELL, **TINY)
    traffic = flowtron_train.Traffic(cell, cfg, SEED, CPU, False, 1.0)
    traffic.setup(adapter(cfg))  # drives the set-up's steps
    want = flowtron_train.reference_steps(cfg, cell["params"], SEED, CPU)
    assert torch.equal(traffic.trainer.dropout_state(),
                       want["dropout_state"])


def test_the_counts_are_the_reference_forwards():
    cfg = tiny(CELL)[2]
    m = cfg["model"]
    g = torch.Generator().manual_seed(seeds.derive(SEED, "weights"))
    W = ref.weights(m, g, CPU)
    B, T_in, T_out = 3, 9, 16
    text = torch.randint(1, m["n_text"], (B, T_in), generator=g)
    mels = torch.randn(B, m["n_mel_channels"], T_out, generator=g)
    with FlopCounterMode(display=False) as c:
        ref.forward_train(W, m, text, torch.tensor([9, 5, 7]), mels,
                          torch.tensor([16, 10, 13]),
                          torch.zeros(B, dtype=torch.long), g)
    assert c.get_total_flops() == counts.forward_flops(m, B, T_in, T_out)
    # A step at the cell's shape: about 13.6 TFLOP.
    full = load("configs", "flowtron-ljspeech")["model"]
    assert 13e12 < counts.step_flops(full, 64, 128, 640) < 14.5e12


def test_the_counts_are_the_programs_forward():
    """The program packs the flows' LSTMs by length: the count with the
    batch's valid frames is what its forward runs."""
    from gantron_tpu_torch.models.flowtron import Flowtron

    cfg = tiny(CELL)[2]
    m = cfg["model"]
    model = Flowtron(adapter(cfg).config(cfg), device="cpu", seed=3)
    g = torch.Generator().manual_seed(4)
    B, T_in, T_out = 3, 9, 16
    text = torch.randint(1, m["n_text"], (B, T_in), generator=g)
    mels = torch.randn(B, m["n_mel_channels"], T_out, generator=g)
    lengths = torch.tensor([16, 10, 13])
    with FlopCounterMode(display=False) as c:
        model(mels, torch.zeros(B, dtype=torch.long), text,
              torch.tensor([9, 5, 7]), lengths)
    valid = int(lengths.sum())
    assert c.get_total_flops() == counts.forward_flops(m, B, T_in, T_out,
                                                       valid)
    assert (counts.step_flops(m, B, T_in, T_out, valid)
            < counts.step_flops(m, B, T_in, T_out))


def test_a_program_without_flowtron_fails_the_check(monkeypatch):
    cfg = tiny(CELL)[2]
    monkeypatch.setitem(sys.modules, "gantron_tpu_torch.models.flowtron",
                        None)
    with pytest.raises(ImportError):
        adapter(cfg).check(cfg)


def test_a_dummy_speaker_embedding_is_refused():
    cfg = tiny(CELL)[2]
    cfg["model"]["dummy_speaker_embedding"] = True
    with pytest.raises(NotImplementedError):
        adapter(cfg).check(cfg)
