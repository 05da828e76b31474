"""Flowtron on the port (``models/flowtron.py``, ``losses.flowtron_loss``,
``train/step.py::make_flowtron_step``, ``ops/rnn.py::lstm_stack``) against
the benchmark's plain reference (``perfbench/reference/flowtron.py``) at
tiny widths on the CPU, on the reference's seeded random weights.

Tolerances: both sides compute in float32 and differ only in the order of
their sums (torch's fused LSTM against an explicit cell loop, the encoder's
float64 conv products against float32 ones, the attention's grid in one
call against blocks of frames). Over two flows of three LSTM layers at
these widths that reads up to 2e-7 on values of order 1 (and 2.4e-7 for a
round trip through ``infer``); the bounds below leave 50 times that, while
the second flow run in time order (the ``no_reverse`` fault) moves z by
over 100 times the bound (5.5e-3), though each flow is near the identity
(its last conv at a standard deviation of 0.01).
"""

import dataclasses

import pytest
import torch

from gantron_tpu_torch.config import FlowtronConfig
from gantron_tpu_torch.losses import flowtron_loss
from gantron_tpu_torch.models import flowtron as port
from gantron_tpu_torch.ops.rnn import LSTMParams, _masked_step, lstm_scan, \
    lstm_stack
from gantron_tpu_torch.train.state import BN_FED_BIAS, wrap_flowtron
from gantron_tpu_torch.train.step import Batch, make_flowtron_step
from perfbench.reference import flowtron as ref
from perfbench.reference.optim import Adam
from torch_threads import one_torch_thread  # noqa: F401

CFG = FlowtronConfig(n_text=30, n_text_dim=16, n_speaker_dim=8,
                     n_attn_channels=12, n_hidden=20, n_mel_channels=6,
                     encoder_embedding_dim=16)
M = CFG.as_dict()
B, T_IN, T_OUT = 3, 7, 11
IN_LENS = torch.tensor([T_IN, 4, 5])
OUT_LENS = torch.tensor([T_OUT, 6, 9])
SPK = torch.zeros(B, dtype=torch.long)
# Float32 summation orders (module docstring).
RTOL = ATOL = 1e-5


def weights(seed=0):
    return ref.weights(M, torch.Generator().manual_seed(seed), "cpu")


def model(W):
    net = port.Flowtron(CFG, "cpu", seed=1)
    net.load_state_dict(W, strict=True)
    return net


def valid(T=T_OUT):
    return (torch.arange(T)[None] < OUT_LENS[:, None])[:, None]


def inputs(seed=2):
    g = torch.Generator().manual_seed(seed)
    text = torch.randint(1, CFG.n_text, (B, T_IN), generator=g)
    mel = torch.randn(B, CFG.n_mel_channels, T_OUT, generator=g) * valid()
    gate = (torch.arange(T_OUT)[None] >= OUT_LENS[:, None] - 1).float()
    return text, mel, gate


def forwards(W, seed=9):
    """The port's and the reference's training passes (the encoder's
    dropout drawn from two generators seeded alike), and both generators."""
    text, mel, _ = inputs()
    g_port = torch.Generator().manual_seed(seed)
    g_ref = torch.Generator().manual_seed(seed)
    got = model(W)(mel, SPK, text, IN_LENS, OUT_LENS, train=True,
                   generator=g_port)
    Wr = {n: x.clone().requires_grad_() for n, x in W.items()}
    want = ref.forward_train(Wr, M, text, IN_LENS, mel, OUT_LENS, SPK, g_ref)
    return got, want, (g_port, g_ref), Wr


def close(a, b):
    torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)


def test_forward_matches_the_reference():
    (z, log_s, gate, attn), (rz, rlog_s, rgate, rattn), gens, _ = forwards(
        weights())
    close(z, rz)
    assert len(log_s) == len(rlog_s) == CFG.n_flows
    for a, b in zip(log_s, rlog_s):
        close(a, b)
    for a, b in zip(attn, rattn):
        close(a, b)
    close(gate, rgate)
    # The encoder's three dropouts, drawn as the reference draws them.
    assert torch.equal(gens[0].get_state(), gens[1].get_state())
    # Attention past a text's length is exactly 0; each row sums to 1.
    for a in attn:
        assert not a[1, :, 4:].any()
        close(a.sum(-1), torch.ones(B, T_OUT))


def test_loss_gradients_and_one_clipped_adam_step():
    W = weights()
    text, mel, gate_t = inputs()
    (z, log_s, gate, _), want, _, Wr = forwards(W)
    flow_l, gate_l = flowtron_loss(z, log_s, gate, gate_t, OUT_LENS)
    ref_l = ref.loss(want, gate_t, OUT_LENS, CFG.sigma)
    close(flow_l + gate_l, ref_l)
    # Every leaf's gradient; the conv biases before a batch-statistics
    # BatchNorm have the exact gradient 0, which both sides hold as noise.
    net = model(W)
    out = net(mel, SPK, text, IN_LENS, OUT_LENS, train=True,
              generator=torch.Generator().manual_seed(9))
    total = sum(flowtron_loss(*out[:3], gate_t, OUT_LENS))
    names, params = zip(*net.named_parameters())
    grads = torch.autograd.grad(total, params)
    want_g = torch.autograd.grad(ref_l, [Wr[n] for n in names])
    top = max(float(g.abs().max()) for g in want_g)
    for n, a, b in zip(names, grads, want_g):
        if BN_FED_BIAS.match(n):
            assert float(a.abs().max()) <= 1e-6 * top, n
        else:
            torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL * top,
                                       msg=n)
    # One step: clip at 1 (this loss's gradient norm is above it), L2,
    # Adam; held where Adam's step is conditioned (a gradient within noise
    # of 0 moves by the learning rate either way).
    net = model(W)
    state, tx = wrap_flowtron(CFG, net, 9)
    step = make_flowtron_step(CFG, net, tx)
    state, metrics = step(state, Batch(text, IN_LENS, mel, gate_t, SPK,
                                       None, OUT_LENS), CFG.learning_rate)
    assert float(metrics["grad_norm"]) > CFG.grad_clip_val
    close(metrics["loss"], ref_l.detach())
    rp = [W[n].clone() for n in names]
    opt = Adam(rp, CFG.grad_clip_val, CFG.weight_decay)
    took = opt.step(rp, want_g, CFG.learning_rate)
    for n, p, q, g in zip(names, net.parameters(), rp, took):
        held = g.abs() >= 1e-3 * g.abs().max()
        if not BN_FED_BIAS.match(n):
            close(p.detach()[held], q[held])


def test_infer_matches_the_reference():
    W = weights(3)
    text, _, _ = inputs()
    z = torch.randn(B, CFG.n_mel_channels, T_OUT,
                    generator=torch.Generator().manual_seed(4))
    got = model(W).eval().infer(z, SPK, text, IN_LENS, OUT_LENS)
    want = ref.infer(W, M, z, SPK, text, IN_LENS, OUT_LENS)
    close(got, want)


def test_forward_of_infer_gives_back_the_latent():
    """Invertibility over the valid frames of a ragged batch: a frame
    depends on no frame past its sequence's length, in either flow."""
    net = model(weights(5)).eval()
    text, _, _ = inputs()
    z = torch.randn(B, CFG.n_mel_channels, T_OUT,
                    generator=torch.Generator().manual_seed(6))
    mel = net.infer(z, SPK, text, IN_LENS, OUT_LENS)
    with torch.no_grad():
        back = net(mel, SPK, text, IN_LENS, OUT_LENS)[0]
    close(back * valid(), z * valid())


def test_the_back_steps_reversal_keeps_padding_at_the_end():
    x = torch.arange(B * T_OUT * 2, dtype=torch.float32).view(B, T_OUT, 2)
    y = port.reverse_by_length(x, OUT_LENS)
    for b, n in enumerate(OUT_LENS.tolist()):
        assert torch.equal(y[b, :n], x[b, :n].flip(0))
        assert torch.equal(y[b, n:], x[b, n:].flip(0))
    assert torch.equal(port.reverse_by_length(y, OUT_LENS), x)
    # The source's flip in time, then a roll by the length.
    assert torch.equal(y, ref.reverse_by_length(x, OUT_LENS))


@pytest.mark.parametrize("layers", [1, 2])
def test_lstm_stack_is_stacked_lstm_scan(layers):
    g = torch.Generator().manual_seed(7)
    ps = [LSTMParams(5 if i == 0 else 8, 8, g) for i in range(layers)]
    xs = torch.randn(4, 9, 5, generator=g)
    lengths = torch.tensor([9, 3, 6, 1])
    out, (h, c) = lstm_stack(ps, xs, lengths)
    # lstm_scan layer upon layer; each layer's final state taken step by
    # step as lstm_scan takes it (held past each length).
    want, hs, cs = xs, [], []
    for p in ps:
        hh = cc = xs.new_zeros(4, 8)
        proj = want @ p.w_ih + p.b
        for t in range(xs.shape[1]):
            hh, cc, _ = _masked_step(p, proj[:, t], hh, cc,
                                     (t < lengths)[:, None])
        hs.append(hh)
        cs.append(cc)
        want = lstm_scan(p, want, lengths)
    close(out, want)
    assert not out[1, 3:].any() and not out[3, 1:].any()
    close(h, torch.stack(hs))
    close(c, torch.stack(cs))
    close(h[-1], want[torch.arange(4), lengths - 1])
    # The gradients reach the weights alike.
    got_g = torch.autograd.grad(out.square().sum(), ps[0].w_hh)
    want_g = torch.autograd.grad(want.square().sum(), ps[0].w_hh)
    close(got_g, want_g)


def test_the_no_reverse_fault_is_caught():
    from perfbench.programs import flowtron as adapter

    W = weights()
    undo = adapter.plant("no_reverse", 0)
    try:
        (z, log_s, _, _), (rz, rlog_s, _, _), _, _ = forwards(W)
    finally:
        undo()
    close(log_s[0], rlog_s[0])  # the first flow runs in time order
    with pytest.raises(AssertionError):
        close(z, rz)
    assert float((z - rz).detach().abs().max()) > 100 * ATOL
    (z, _, _, _), (rz, _, _, _), _, _ = forwards(W)
    close(z, rz)


def test_the_configuration_is_the_sources():
    """The widths of NVIDIA/flowtron's LJSpeech ``model_config`` and the
    reference's count of its parameters (about 61M)."""
    import math

    m = dataclasses.asdict(FlowtronConfig())
    assert (m["n_text"], m["n_text_dim"], m["n_speaker_dim"], m["n_flows"],
            m["n_attn_channels"], m["n_hidden"], m["n_lstm_layers"]) == (
        185, 512, 128, 2, 640, 1024, 2)
    n = sum(math.prod(s) for k, s in ref.param_shapes(m).items()
            if "running" not in k)
    assert 60e6 < n < 62e6
