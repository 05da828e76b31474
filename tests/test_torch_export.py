"""Port parity of the serving export (gantron_tpu_torch/export.py): the
``torch.export`` artifact against the JAX package's ``jax.export`` artifact,
and the loaded program against the eager function it was exported from.

Against JAX (the JAX artifact exported for the CPU, as tests/test_export.py
does) the weights are the same (utils/jax_weights.py), prenet dropout is off
on both sides and there is no noise, so that neither side draws: the mel
within 1e-4 and the lengths exactly, with the gate threshold picked as
tests/test_torch_tacotron2.py picks it. Against the eager function the draws
are on (noise, prenet dropout, WaveGlow's z) and the default generators are
seeded alike: within 1e-5.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import gantron_tpu.export as jax_export
import gantron_tpu.models.tacotron2 as jax_taco
from gantron_tpu_torch import export
from gantron_tpu_torch.models.tacotron2 import Tacotron2
from gantron_tpu_torch.models.waveglow import (WaveGlow, WaveGlowConfig,
                                               random_params)
from gantron_tpu_torch.ops.quant import qmm
from test_torch_conditioned import CONFIGS, init_jax_weights
from test_torch_tacotron2 import (pick_gate_threshold, port_model, texts,
                                  tiny_hparams)
from torch_threads import one_torch_thread  # noqa: F401

TEXT_LEN = 9
LENGTHS = np.array([9, 5, 7], np.int64)


def jax_exported(jhp, variables, path, B, conditioned):
    """The JAX artifact at (B, TEXT_LEN), exported for the CPU with prenet
    dropout off, and loaded."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_taco, "_dropout", lambda x, r, k: x)
        jax_export.export_tts(jax_taco.Tacotron2(jhp), variables, path,
                              batch_size=B, text_len=TEXT_LEN,
                              platforms=("cpu",))
    return jax_export.load_exported(path)


def set_gate_threshold(jhp, hp, port, ids, lengths, emotions=None,
                       speaker=None):
    """A threshold at which every sample stops cleanly, on both sides."""
    hp.gate_threshold = 1.0
    gate = port.infer(torch.from_numpy(ids), None, emotions, speaker,
                      text_lengths=torch.from_numpy(lengths))[2]
    hp.gate_threshold = jhp.gate_threshold = pick_gate_threshold(gate.numpy())


@pytest.fixture(scope="module")
def vanilla(tmp_path_factory):
    """No noise: JAX weights, the port on them (dropout off, the gate
    threshold picked on ``texts``), and the port's shape-polymorphic
    artifact of that model, loaded."""
    jhp, hp = tiny_hparams(use_noise=False)
    variables = init_jax_weights(jhp)
    port = port_model(variables, hp)
    set_gate_threshold(jhp, hp, port, texts(hp, LENGTHS, TEXT_LEN), LENGTHS)
    path = str(tmp_path_factory.mktemp("vanilla") / "poly.pt2")
    export.export_tts(port, path, batch_size=None, text_len=None,
                      device="cpu")
    return jhp, hp, variables, port, export.load_exported(path)


@pytest.mark.parametrize("config", ["vanilla", "labels"])
def test_export_matches_the_jax_artifact(tmp_path, request, config):
    """No noise, dropout off: the port's artifact and JAX's give the same
    postnet mel (1e-4) and lengths. ``vanilla`` serves the polymorphic
    artifact at JAX's static shape; ``labels`` is a static export that
    takes emotions and speaker ids as inputs."""
    ids = texts(tiny_hparams()[1], LENGTHS, TEXT_LEN)
    extra = []
    if config == "vanilla":
        jhp, hp, variables, _, serve = request.getfixturevalue("vanilla")
    else:
        jhp, hp = tiny_hparams(**CONFIGS["labels"])
        variables = init_jax_weights(jhp)
        port = port_model(variables, hp)
        rng = np.random.RandomState(3)
        extra = [rng.rand(3, 5).astype(np.float32),
                 rng.randint(0, 123, 3).astype(np.int64)]
        set_gate_threshold(jhp, hp, port, ids, LENGTHS,
                           *[torch.from_numpy(x) for x in extra])
        path = str(tmp_path / "tts.pt2")
        nbytes = export.export_tts(port, path, batch_size=3,
                                   text_len=TEXT_LEN, device="cpu")
        serve = export.load_exported(path)
        assert nbytes > 0
    assert serve.conditioned == (config == "labels")
    mel, lengths = serve(ids, LENGTHS, 0, *extra)

    j_serve = jax_exported(jhp, variables, str(tmp_path / "tts.jax"), 3,
                           config == "labels")
    j_mel, j_len = j_serve(jnp.asarray(ids, jnp.int32),
                           jnp.asarray(LENGTHS, jnp.int32),
                           jax.random.PRNGKey(0),
                           *[jnp.asarray(x, dtype=jnp.int32
                                         if x.dtype == np.int64 else None)
                             for x in extra])
    assert mel.shape == (3, hp.n_mel_channels, hp.max_decoder_steps)
    np.testing.assert_allclose(mel.numpy(), np.asarray(j_mel), atol=1e-4)
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(j_len))
    assert len(set(lengths.tolist())) > 1
    assert (lengths.numpy() < hp.max_decoder_steps).all()


def test_polymorphic_export_serves_two_batches_and_two_lengths(vanilla):
    """batch_size=None, text_len=None: one artifact at (2, 6) and (3, 11),
    each against the eager decode of the same model (dropout off, no
    noise)."""
    _, hp, _, model, serve = vanilla
    for B, T in ((2, 6), (3, 11)):
        lengths = np.full(B, T, np.int64)
        lengths[-1] = T - 2
        ids = texts(hp, lengths, T, seed=B)
        mel, out_len = serve(ids, lengths, 0)
        ref = model.infer(torch.from_numpy(ids),
                          text_lengths=torch.from_numpy(lengths))
        assert mel.shape == ref[1].shape
        np.testing.assert_allclose(mel.numpy(), ref[1].numpy(), atol=1e-5)
        np.testing.assert_array_equal(out_len.numpy(), ref[4].numpy())


def test_loaded_program_refuses_tensors_on_another_device(vanilla):
    """A program exported on the CPU runs on the CPU: array-likes are moved
    there, a tensor that lies on another device is refused, not copied."""
    hp, serve = vanilla[1], vanilla[4]
    ids = texts(hp, LENGTHS, TEXT_LEN)
    assert serve.device == torch.device("cpu")
    mel, _ = serve(ids.tolist(), torch.from_numpy(LENGTHS), 0)
    assert mel.device == torch.device("cpu")
    with pytest.raises(ValueError, match="where it was exported"):
        serve(torch.from_numpy(ids).to("meta"), LENGTHS, 0)
    with pytest.raises(ValueError, match="where it was exported"):
        serve(ids, torch.from_numpy(LENGTHS).to("meta"), 0)


def small_waveglow():
    cfg = WaveGlowConfig(n_mel_channels=80, n_flows=2, n_group=4,
                         n_early_every=2, n_early_size=1, n_layers=2,
                         n_channels=8, upsample_kernel=16, upsample_stride=8)
    return WaveGlow(cfg, random_params(torch.Generator().manual_seed(1), cfg),
                    device="cpu")


def test_quantized_export_with_draws_matches_the_eager_function(tmp_path):
    """int8 recurrence matrices, noise, prenet dropout and a WaveGlow: the
    loaded program against the eager ``make_infer_fn`` under the same seed
    (1e-5, lengths exact), its products through the qmm op's CPU
    implementation (4 a step, no kernel launch), and another seed drawing
    otherwise."""
    _, hp = tiny_hparams(quantized_inference=True)
    model = Tacotron2(hp, device="cpu", seed=3)
    waveglow = small_waveglow()
    path = str(tmp_path / "q.pt2")
    export.export_tts(model, path, batch_size=3, text_len=TEXT_LEN,
                      waveglow=waveglow, device="cpu")
    serve = export.load_exported(path)
    fn, conditioned = export.make_infer_fn(model, waveglow=waveglow)
    assert not conditioned
    ids = texts(hp, LENGTHS, TEXT_LEN)
    launches = qmm.launches
    with torch.profiler.profile() as prof:
        wav, lengths = serve(ids, LENGTHS, 11)
    calls = sum(e.count for e in prof.key_averages()
                if e.key == "gantron_tpu_torch::qmm")
    assert calls == 4 * hp.max_decoder_steps and qmm.launches == launches
    ref_wav, ref_len = export.seeded_call(
        fn, 11, "cpu", torch.from_numpy(ids), torch.from_numpy(LENGTHS))
    assert wav.shape == (3, hp.max_decoder_steps * 8)
    np.testing.assert_allclose(wav.numpy(), ref_wav.numpy(), atol=1e-5)
    np.testing.assert_array_equal(lengths.numpy(), ref_len.numpy())
    other, _ = serve(ids, LENGTHS, 12)
    assert not torch.allclose(other, wav)
    again, _ = serve(ids, LENGTHS, 11)
    assert torch.equal(again, wav)


def test_export_refuses_weights_on_another_device(tmp_path, monkeypatch):
    """Weights on the CPU, the program asked for elsewhere (the meta device
    here, in place of a card): ``export_tts`` refuses before tracing."""
    _, hp = tiny_hparams()
    model = Tacotron2(hp, device="cpu")
    monkeypatch.setattr(export, "resolve_device",
                        lambda device: torch.device("meta"))
    with pytest.raises(ValueError, match="a program runs where its weights "
                                         "are"):
        export.export_tts(model, str(tmp_path / "x.pt2"), device="cuda")
    assert not (tmp_path / "x.pt2").exists()


def test_pad_text_pads_and_rejects_overflow():
    out = export.pad_text([3, 4, 5], 6)
    assert out.shape == (1, 6) and out.tolist() == [[3, 4, 5, 0, 0, 0]]
    np.testing.assert_array_equal(
        out, jax_export.pad_text(np.array([3, 4, 5]), 6))
    with pytest.raises(ValueError, match="exceeds"):
        export.pad_text(np.ones((2, 7)), 6)
