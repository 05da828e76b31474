"""The operation counts of ``perfbench/counts`` against
``FlopCounterMode`` over the frozen reference at a small width: the
matrix products and convolutions of synthesis and of a training step's
forward pass."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import weights
from perfbench.counts import flops, qmm
from perfbench.reference import discriminator as ref_d
from perfbench.reference import tacotron2 as ref_taco
from perfbench.reference import waveglow as ref_wg
from perfbench.tests.tiny import cells, tiny

CPU = torch.device("cpu")


def counted(fn):
    with FlopCounterMode(display=False) as c:
        fn()
    return c.get_total_flops()


@pytest.mark.parametrize("cell", cells("synth_batch"))
def test_synthesis_counts(cell):
    _, c, cfg, _ = tiny(cell)
    m = cfg["model"]
    g = torch.Generator().manual_seed(0)
    W = weights.tacotron2(m, g, CPU)
    P = weights.waveglow(cfg["waveglow"], g, CPU, m["n_mel_channels"],
                         dtype=torch.float32)
    n_chars, S = 7, 11
    ids = torch.randint(1, 148, (1, n_chars), generator=g)
    lengths = torch.tensor([n_chars])
    style = torch.rand(1, 1, m["noise_size"], generator=g)
    spk = torch.tensor([3]) if m["vesus"] else None
    emo = torch.rand(1, 5, generator=g) if m["vesus"] else None
    frames = torch.randn(1, m["n_mel_channels"], S, generator=g)

    def draws(t):
        return (torch.rand(1, m["prenet_dim"], generator=g),
                torch.rand(1, m["prenet_dim"], generator=g))

    taco = counted(lambda: ref_taco.decode_given_frames(
        W, m, ids, lengths, style, spk, emo, frames, draws))
    post = counted(lambda: ref_taco.postnet(W, m, frames))
    z = [torch.randn((1,) + s, generator=g)
         for s in ref_wg.z_shapes(cfg["waveglow"], S)]
    wave = counted(lambda: ref_wg.infer(cfg["waveglow"], P, frames, z, 0.5))
    assert taco + post == flops.tacotron2_flops(m, n_chars, S)
    assert wave == flops.waveglow_flops(cfg["waveglow"], S,
                                        m["n_mel_channels"])
    assert taco + post + wave == flops.synthesis_flops(cfg, n_chars, S)


@pytest.mark.parametrize("cell", cells("train_cycle"))
def test_training_forward_counts(cell):
    _, c, cfg, _ = tiny(cell)
    m = cfg["model"]
    g = torch.Generator().manual_seed(1)
    W = weights.tacotron2(m, g, CPU)
    Wd = weights.discriminator(m, g, CPU)
    B, T_in, T_out = 3, 9, 16
    text = torch.randint(1, 148, (B, T_in), generator=g)
    tl = torch.tensor([9, 5, 7])
    ol = torch.tensor([16, 10, 13])
    mels = torch.randn(B, m["n_mel_channels"], T_out, generator=g)
    style = torch.rand(B, 1, m["noise_size"], generator=g)

    def forward():
        out = ref_taco.forward_train(W, m, text, tl, mels, ol, style, g)
        ref_d.loss(Wd, m, out[1], ol, g)

    assert counted(forward) == flops.g_forward_flops(m, B, T_in, T_out)
    assert counted(lambda: ref_d.loss(Wd, m, mels, ol, g)) == \
        flops.discriminator_flops(m, B, T_out)
    assert flops.train_cycle_flops(m, B, T_in, T_out) == 3 * (
        2 * flops.g_forward_flops(m, B, T_in, T_out)
        + 2 * flops.discriminator_flops(m, B, T_out))


def test_full_width_counts_are_those_the_issue_worked_out():
    from perfbench.tests.tiny import load

    lj = load("configs", "gantron-ljspeech")
    m = lj["model"]
    # A G step at B 128, T_in 128, T_out 640: about 14 TFLOP.
    g_step = 3 * flops.g_forward_flops(m, 128, 128, 640)
    assert 13e12 < g_step < 16e12
    # WaveGlow: about 20 MFLOP a sample.
    per_sample = flops.waveglow_flops(lj["waveglow"], 100, 80) / (100 * 256)
    assert 19e6 < per_sample < 22e6


def test_qmm_bound_is_chip_smokes():
    # chip_smoke.py's bounds of the four recurrence products of a decoder
    # step with a 1,024-wide memory (PERF.md's kernel table): 6.31 us at
    # B = 1 (bytes), 20.03 us at B = 32 (operations).
    from perfbench.tests.tiny import load

    m = load("configs", "gantron-ljspeech")["model"]
    t1, kind1 = qmm.qmm_bound_s(qmm.decoder_step_products(m, 1))
    t32, kind32 = qmm.qmm_bound_s(qmm.decoder_step_products(m, 32))
    assert kind1 == "bytes" and round(t1 * 1e6, 2) == 6.31
    assert kind32 == "operations" and round(t32 * 1e6, 2) == 20.03
