"""The port's spans (``gantron_tpu_torch/utils/profiling.py``): off, they
change and record nothing; under ``torch.profiler`` they nest as the layers
do (Flowtron's too); inside ``tracing()`` ``summary()`` counts them, the
launch counters and the attention grid's elements;
``trace(dir)`` writes both files; and a profiler slice reduced as the
benchmark reduces it (``perfbench/trace.py``) names the host's time between
operators by span."""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from gantron_tpu_torch.config import FlowtronConfig, HParams
from gantron_tpu_torch.models.flowtron import Flowtron
from gantron_tpu_torch.models.tacotron2 import Tacotron2
from gantron_tpu_torch.models.waveglow import (WaveGlow, WaveGlowConfig,
                                               random_params)
from gantron_tpu_torch.train.state import create_train_state, wrap_flowtron
from gantron_tpu_torch.train.step import (Batch, make_flowtron_step,
                                          make_train_steps)
from gantron_tpu_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401

TINY = dict(
    symbols_embedding_dim=32, encoder_embedding_dim=32,
    encoder_n_convolutions=2, attention_rnn_dim=48, decoder_rnn_dim=48,
    prenet_dim=16, attention_dim=24, attention_location_n_filters=4,
    attention_location_kernel_size=7, postnet_embedding_dim=32,
    postnet_n_convolutions=3, noise_size=8, discriminator_dim=32,
    max_decoder_steps=24, use_noise=True, use_labels=False)
TINY_WAVEGLOW = WaveGlowConfig(n_mel_channels=80, n_flows=4, n_group=4,
                               n_early_every=2, n_early_size=1, n_layers=2,
                               n_channels=8, upsample_kernel=8,
                               upsample_stride=4)
B, T_IN, T_OUT, STEPS = 3, 9, 12, 7


def tiny_hp(**over):
    hp = HParams()
    hp.add_params({**TINY, **over})
    return hp


def batch(hp, device="cpu"):
    g = torch.Generator().manual_seed(3)
    text_lengths = torch.tensor([T_IN, T_IN - 2, T_IN - 4])
    text = torch.randint(1, hp.n_symbols, (B, T_IN), generator=g)
    text[1, T_IN - 2:] = text[2, T_IN - 4:] = 0
    output_lengths = torch.tensor([T_OUT, T_OUT - 2, T_OUT - 4])
    valid = torch.arange(T_OUT)[None] < output_lengths[:, None]
    mels = (torch.randn(B, hp.n_mel_channels, T_OUT, generator=g)
            * valid[:, None])
    gate = (torch.arange(T_OUT)[None] >= output_lengths[:, None] - 1).float()
    return Batch(*(x.to(device) for x in (
        text, text_lengths, mels, gate, torch.zeros(B, dtype=torch.long),
        torch.zeros(B, 5), output_lengths)))


def decode(model, b, device="cpu"):
    """``model.infer`` of ``STEPS`` steps: (outputs, generator states)."""
    gen = torch.Generator(device=device).manual_seed(1)
    noise = torch.Generator(device=device).manual_seed(2)
    out = model.infer(b.text, max_steps=STEPS, text_lengths=b.text_lengths,
                      generator=gen, noise_generator=noise)
    return out, [gen.get_state(), noise.get_state()]


def infer(hp=None, device="cpu"):
    """A tiny Tacotron2 and its decode."""
    hp = hp or tiny_hp()
    return decode(Tacotron2(hp, device=device, seed=0).eval(),
                  batch(hp, device), device)


def vocode():
    params = random_params(torch.Generator().manual_seed(0), TINY_WAVEGLOW)
    wg = WaveGlow(TINY_WAVEGLOW, params, "cpu")
    mel = torch.randn(2, 80, 5, generator=torch.Generator().manual_seed(4))
    gen = torch.Generator().manual_seed(5)
    return wg.infer(mel, generator=gen), [gen.get_state()]


def g_step(K=1, **over):
    hp = tiny_hp(n_frames_per_step=K, **over)
    b = batch(hp)
    state, G, D, g_tx, d_tx = create_train_state(hp, 0, b, device="cpu")
    step, _, _ = make_train_steps(hp, G, D, g_tx, d_tx)
    state, metrics, fake = step(state, b, 1e-3, 1.0)
    return ([metrics, fake, list(state.g_model.state_dict().values()),
             state.g_opt_state.mu],
            [state.dropout_generator.get_state(),
             state.noise_generator.get_state()])


def d_step():
    hp = tiny_hp()
    b = batch(hp)
    state, G, D, g_tx, d_tx = create_train_state(hp, 0, b, device="cpu")
    _, step, _ = make_train_steps(hp, G, D, g_tx, d_tx)
    state, metrics = step(state, b.mels, b.output_lengths, b.mels * 0.5,
                          b.output_lengths, 1e-3)
    return ([metrics, list(state.d_model.state_dict().values()),
             state.d_opt_state.nu],
            [state.dropout_generator.get_state(),
             state.noise_generator.get_state()])


FLOWTRON = FlowtronConfig(n_text_dim=16, n_speaker_dim=8, n_attn_channels=12,
                          n_hidden=20, n_mel_channels=80,
                          encoder_embedding_dim=16)


def flowtron_step():
    """One tiny Flowtron training step on ``batch``'s shapes."""
    b = batch(tiny_hp())
    net = Flowtron(FLOWTRON, "cpu", seed=0)
    with torch.no_grad():  # flows that are not the identity
        for flow in net.flows:
            flow.conv_w.normal_(0, 0.01, generator=torch.Generator()
                                .manual_seed(8))
    state, tx = wrap_flowtron(FLOWTRON, net, 0)
    state, metrics = make_flowtron_step(FLOWTRON, net, tx)(state, b, 1e-3)
    return ([metrics, list(net.state_dict().values()), state.opt_state.mu],
            [state.dropout_generator.get_state()])


def flowtron_infer():
    b = batch(tiny_hp())
    net = Flowtron(FLOWTRON, "cpu", seed=0).eval()
    z = torch.randn(B, 80, T_OUT, generator=torch.Generator().manual_seed(4))
    return [net.infer(z, b.speaker, b.text, b.text_lengths,
                      b.output_lengths)], []


RUNS = {"tacotron2.infer": infer, "waveglow.infer": vocode, "g_step": g_step,
        "g_step_rollout": lambda: g_step(adversarial_rollouts=True),
        "d_step": d_step, "flowtron.step": flowtron_step,
        "flowtron.infer": flowtron_infer}


def leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def refuse(*_, **__):
    raise AssertionError("called with the spans off")


@pytest.mark.parametrize("run", sorted(RUNS))
def test_spans_off_record_nothing_and_on_change_nothing(run, monkeypatch):
    """Outside a profiler and ``tracing()`` a span opens no
    ``record_function``, takes no CUDA event, waits for no card and leaves
    the record empty; spans on give bit-identical outputs and the same
    generator states (torch's default one included)."""
    with profiling.tracing() as record:
        pass
    assert profiling.span("a") is profiling.span("b")
    with monkeypatch.context() as m:
        m.setattr(torch.profiler, "record_function", refuse)
        m.setattr(torch.cuda, "Event", refuse)
        m.setattr(torch.cuda, "synchronize", refuse)
        torch.manual_seed(7)
        off = RUNS[run]() + (torch.get_rng_state(),)
    assert record.spans == [] and profiling.summary()["spans"] == {}
    with profiling.tracing():
        torch.manual_seed(7)
        on = RUNS[run]() + (torch.get_rng_state(),)
    assert profiling.summary()["spans"]
    a, b = leaves(off), leaves(on)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


NESTING = {
    "tacotron2.infer": [("encoder", "tacotron2.infer"),
                        ("decoder.loop", "tacotron2.infer"),
                        ("decoder.step", "decoder.loop"),
                        ("postnet", "tacotron2.infer")],
    "waveglow.infer": [("vocoder.upsample", "vocoder.infer"),
                       ("vocoder.flows", "vocoder.infer")],
    "g_step": [("g_step.forward", "g_step"), ("encoder", "g_step.forward"),
               ("decoder.loop", "g_step.forward"),
               ("decoder.step", "decoder.loop"),
               ("postnet", "g_step.forward"), ("g_step.loss", "g_step"),
               ("g_step.backward", "g_step"), ("g_step.deferred_dw", "g_step"),
               ("g_step.all_reduce", "g_step"), ("g_step.update", "g_step")],
    "g_step_rollout": [("g_step.identification", "g_step"),
                       ("g_step.forward", "g_step"),
                       ("decoder.step", "decoder.loop")],
    "d_step": [("d_step.forward", "d_step"), ("d_step.backward", "d_step"),
               ("d_step.update", "d_step")],
    "flowtron.step": [("flowtron.forward", "flowtron.step"),
                      ("encoder", "flowtron.forward"),
                      ("flowtron.flow", "flowtron.forward"),
                      ("flowtron.lstm", "flowtron.flow"),
                      ("flowtron.attention", "flowtron.flow"),
                      ("flowtron.loss", "flowtron.step"),
                      ("flowtron.backward", "flowtron.step"),
                      ("flowtron.update", "flowtron.step")],
    "flowtron.infer": [("encoder", "flowtron.infer"),
                       ("flowtron.infer.step", "flowtron.infer")],
}


def span_parent(event):
    """The name of the innermost ``gantron/`` range around ``event``."""
    p = event.cpu_parent
    while p is not None and not p.name.startswith(profiling.PREFIX):
        p = p.cpu_parent
    return None if p is None else p.name[len(profiling.PREFIX):]


@pytest.mark.parametrize("run", sorted(NESTING))
def test_profiler_events_nest_as_the_layers(run):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        RUNS[run]()
    spans = {}
    for e in prof.events():
        if e.name.startswith(profiling.PREFIX):
            spans.setdefault(e.name[len(profiling.PREFIX):], set()).add(
                span_parent(e))
    for child, parent in NESTING[run]:
        assert spans.get(child) == {parent}, (child, spans.get(child))
    top = {"waveglow.infer": "vocoder.infer",
           "g_step_rollout": "g_step"}.get(run, run)
    assert spans[top] == {None}


def check_self_times(s):
    for name, v in s["spans"].items():
        assert 0 <= v["self_s"] <= v["host_s"], name


@pytest.mark.parametrize("case", ["decode", "teacher_forced_k1",
                                  "teacher_forced_k2"])
def test_summary_counts_the_decoder_steps(case):
    """S steps of a free-running decode, T_out / K of the teacher-forced
    loop; every self time within its total; no kernel launched on the
    CPU."""
    with profiling.tracing():
        if case == "decode":
            infer(tiny_hp(quantized_inference=True))
        else:
            g_step(K=int(case[-1]))
    s = profiling.summary()
    steps = STEPS if case == "decode" else T_OUT // int(case[-1])
    assert s["spans"]["decoder.step"]["calls"] == steps
    assert s["spans"]["decoder.step"]["parents"] == ["decoder.loop"]
    assert s["spans"]["decoder.loop"]["calls"] == 1
    assert s["counters"] == {"qmm.launches": 0, "log_mel.launches": 0,
                             "flowtron.energy_elements": 0}
    assert all(v["device_s"] is None for v in s["spans"].values())
    check_self_times(s)


def test_summary_counts_flowtrons_spans_and_its_attention_grid():
    """A training step: a ``flowtron.flow`` a flow, each with two
    ``flowtron.lstm`` and one ``flowtron.attention``, and the whole (B,
    T_out, T_in, A) grid a flow; inference: a ``flowtron.infer.step`` a
    frame a flow, a (B, 1, T_in, A) grid each. Nothing is recorded
    outside ``tracing()``."""
    flows, A = FLOWTRON.n_flows, FLOWTRON.n_attn_channels
    with profiling.tracing():
        flowtron_step()
    s = profiling.summary()
    calls = {n: v["calls"] for n, v in s["spans"].items()}
    assert calls == {"flowtron.step": 1, "flowtron.forward": 1, "encoder": 1,
                     "flowtron.flow": flows, "flowtron.lstm": 2 * flows,
                     "flowtron.attention": flows, "flowtron.loss": 1,
                     "flowtron.backward": 1, "flowtron.update": 1}
    assert s["spans"]["flowtron.lstm"]["parents"] == ["flowtron.flow"]
    assert s["counters"]["flowtron.energy_elements"] == (
        flows * B * T_OUT * T_IN * A)
    check_self_times(s)
    with profiling.tracing():
        flowtron_infer()
    s = profiling.summary()
    assert s["spans"]["flowtron.infer.step"]["calls"] == flows * T_OUT
    assert s["spans"]["flowtron.infer.step"]["device_s"] is None
    assert s["counters"]["flowtron.energy_elements"] == (
        flows * T_OUT * B * T_IN * A)
    flowtron_step()
    assert profiling.summary() == s


def test_summary_counts_four_qmm_launches_a_decoder_step():
    """The int8 decode on a card: 4 ``qmm`` launches a step, and a device
    extent for every span."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: qmm is not launched on the CPU")
    infer(tiny_hp(quantized_inference=True), "cuda")  # builds the kernel
    with profiling.tracing():
        infer(tiny_hp(quantized_inference=True), "cuda")
    s = profiling.summary()
    assert s["counters"]["qmm.launches"] == 4 * STEPS
    assert s["spans"]["decoder.step"]["calls"] == STEPS
    assert s["spans"]["decoder.step"]["device_s"] is None
    assert all(v["device_s"] >= 0 for n, v in s["spans"].items()
               if n != "decoder.step")
    check_self_times(s)


def test_trace_writes_the_chrome_trace_and_the_spans(tmp_path):
    with profiling.trace(str(tmp_path)):
        infer()
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "gantron/decoder.step" in names
    with open(tmp_path / "spans.json") as f:
        spans = json.load(f)
    assert spans["spans"]["decoder.step"]["calls"] == STEPS
    assert spans["spans"]["tacotron2.infer"]["parents"] == []
    assert set(spans["counters"]) == {"qmm.launches", "log_mel.launches",
                                      "flowtron.energy_elements"}


class StandInKernel:
    """A device event over a host operator's interval."""

    def __init__(self, e):
        self.e = e

    def name(self):
        return "kernel of " + self.e.name()

    def start_ns(self):
        return self.e.start_ns()

    def duration_ns(self):
        return self.e.duration_ns()

    def device_type(self):
        return "DeviceType.CUDA"

    def is_user_annotation(self):
        return False


def test_benchmark_slice_names_gaps_outside_operators_by_span():
    """A profiled tiny decode reduced by ``perfbench.trace.summarize``. On
    the CPU each ``aten::`` operator stands in for a kernel over its own
    interval, so the card idles just where the host runs outside every
    operator: those gaps take a ``gantron/`` span's name, not "host,
    outside any operator"."""
    from perfbench.trace import MARK, summarize

    hp = tiny_hp()
    model, b = Tacotron2(hp, device="cpu", seed=0).eval(), batch(hp)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(MARK):
            decode(model, b)
    events = list(prof.profiler.kineto_results.events())
    kernels = [StandInKernel(e) for e in events
               if e.name().startswith("aten::")]
    gaps = dict(summarize(events + kernels)["idle_gaps"])
    named = {k: v for k, v in gaps.items()
             if k.startswith(profiling.PREFIX)}
    assert profiling.PREFIX + "decoder.step" in named
    assert sum(named.values()) > gaps.get("host, outside any operator", 0)
