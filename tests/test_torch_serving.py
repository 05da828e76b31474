"""Port parity of the serving entry point: ``gantron_tpu_torch.tts.Synthesizer``
against the JAX package's ``Synthesizer`` with the same weights, plus the
port's device and import rules."""

import os
import subprocess
import sys

import numpy as np
import pytest

import torch

import gantron_tpu.models.tacotron2 as jax_taco
from gantron_tpu.tts import Synthesizer as JaxSynthesizer
from gantron_tpu_torch.models.tacotron2 import Tacotron2
from gantron_tpu_torch.models.waveglow import (WaveGlow, WaveGlowConfig,
                                               random_params)
from gantron_tpu_torch.text import text_to_sequence
from gantron_tpu_torch.tts import Synthesizer
from test_torch_tacotron2 import (jax_variables, no_jax_dropout,  # noqa: F401
                                  pick_gate_threshold, port_model, texts,
                                  tiny_hparams, variables_for)
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXT = "Dr. Who paid $3 for 2 cups of tea."


@pytest.fixture
def synthesizers(jax_variables, no_jax_dropout):  # noqa: F811
    jhp, hp = tiny_hparams(quantized_inference=True, max_decoder_steps=10)
    variables = variables_for(jax_variables, 1)
    port = Synthesizer(hp, port_model(variables, hp), device="cpu")
    ref = JaxSynthesizer(jax_taco.Tacotron2(jhp), variables, jhp)
    return ref, port


def _set_threshold(ref, port, ids, lengths, style):
    """A gate threshold with a clean margin for this decode (see
    test_torch_tacotron2.pick_gate_threshold)."""
    port.hp.gate_threshold = 1.0
    out = port.model.infer(torch.from_numpy(ids), torch.from_numpy(style),
                           text_lengths=torch.from_numpy(lengths))
    thr = pick_gate_threshold(out[2].numpy())
    port.hp.gate_threshold = ref.hp.gate_threshold = thr


def test_infer_mel_on_a_string_matches_jax(synthesizers):
    ref, port = synthesizers
    ids = np.asarray(text_to_sequence(TEXT, port.hp.text_cleaners))[None]
    style = np.random.RandomState(0).rand(1, 1, port.hp.noise_size) \
        .astype(np.float32)
    _set_threshold(ref, port, ids, np.array([ids.shape[1]]), style)
    j_mel, j_len = ref.infer_mel(TEXT, style=style)
    p_mel, p_len = port.infer_mel(TEXT, style=torch.from_numpy(style))
    assert p_len == j_len < port.hp.max_decoder_steps
    np.testing.assert_allclose(p_mel.numpy(), j_mel, atol=1e-4)


def test_infer_mel_on_a_ragged_batch_matches_jax(synthesizers):
    ref, port = synthesizers
    lengths = np.array([9, 4, 6], np.int64)
    ids = texts(port.hp, lengths, 9)  # zero-padded: lengths are derived
    style = np.random.RandomState(1).rand(3, 1, port.hp.noise_size) \
        .astype(np.float32)
    _set_threshold(ref, port, ids, lengths, style)
    j_out = ref.infer_mel(ids, style=style)
    p_out = port.infer_mel(ids, style=torch.from_numpy(style))
    assert len(p_out) == len(j_out) == 3
    for (p_mel, p_len), (j_mel, j_len) in zip(p_out, j_out):
        assert p_len == j_len
        np.testing.assert_allclose(p_mel.numpy(), j_mel, atol=1e-4)


def test_tts_with_waveglow_returns_the_decoded_length():
    _, hp = tiny_hparams(max_decoder_steps=6, gate_threshold=1.0)
    synth = Synthesizer(hp, Tacotron2(hp, device="cpu", seed=3),
                        device="cpu")
    cfg = WaveGlowConfig(n_mel_channels=hp.n_mel_channels, n_flows=2,
                         n_layers=2, n_channels=16,
                         upsample_stride=hp.hop_length)
    waveglow = WaveGlow(cfg, random_params(torch.Generator().manual_seed(0),
                                           cfg), device="cpu")
    wav = synth.tts(TEXT, waveglow, seed=4)
    assert wav.dtype == np.float32
    assert wav.shape == (hp.max_decoder_steps * hp.hop_length,)
    assert np.isfinite(wav).all()


@pytest.mark.parametrize("steps", [1, 7])
def test_tts_without_waveglow_vocodes_with_griffin_lim(steps):
    """L decoded frames give (L - 1) * hop samples, or L * hop below the
    n_fft / hop + 1 frames that the inverse STFT pads a mel up to."""
    _, hp = tiny_hparams(max_decoder_steps=steps, gate_threshold=1.0)
    synth = Synthesizer(hp, Tacotron2(hp, device="cpu", seed=3),
                        device="cpu")
    wav = synth.tts(TEXT, seed=4, griffin_lim_iters=2)
    L = synth.infer_mel(TEXT, seed=4)[1]
    min_frames = hp.filter_length // hp.hop_length + 1
    assert L == steps
    assert wav.dtype == np.float32
    assert wav.shape == (min(L, max(L, min_frames) - 1) * hp.hop_length,)
    assert np.isfinite(wav).all()
    np.testing.assert_array_equal(
        wav, synth.tts(TEXT, seed=4, griffin_lim_iters=2))


def test_default_device_constructors_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    from gantron_tpu_torch.audio import STFT, MelSpectrogram
    from gantron_tpu_torch.audio.mel import PowerMelDB
    from gantron_tpu_torch.data.dataset import TextMelDataset

    _, hp = tiny_hparams()
    filelist = tmp_path / "list.txt"
    filelist.write_text("")
    for make in (lambda: Synthesizer(hp), lambda: Tacotron2(hp),
                 MelSpectrogram, STFT, PowerMelDB,
                 lambda: TextMelDataset([str(filelist)], hp, "")):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_port_imports_neither_jax_nor_the_jax_package(tmp_path):
    """Every module of the port imports without jax, flax, the JAX package,
    sklearn or matplotlib, and the study scripts import with no side
    effect: nothing is written to the working or temporary directory."""
    code = (
        "import importlib, os, pkgutil, sys, tempfile\n"
        "import gantron_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__,\n"
        "                                              pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'gantron_tpu', 'sklearn',\n"
        "              'matplotlib'))\n"
        "need = {'gantron_tpu_torch.' + n for n in (\n"
        "    'models.classifier', 'eval.classifier',\n"
        "    'eval.inference_classifier', 'eval.study', 'eval.clustering',\n"
        "    'cli.classifier', 'cli.inference_classifier',\n"
        "    'cli.study_model', 'cli.clustering', 'cli.check_kmeans')\n"
        "    + tuple('scripts.' + n for n in (\n"
        "        '_study_common', 'run_study', 'gan_mode_study',\n"
        "        'gan_texture_study', 'gan_composed_study',\n"
        "        'gan_factorial_study', 'gan_continuous_study',\n"
        "        'gan_vector_study', 'evidence_run', 'mode_attribution',\n"
        "        'calibrate_knob', 'continuous_extrapolation',\n"
        "        'vector_unmix', 'calibrate_factor_sensor',\n"
        "        'calibrate_rescue_floor'))}\n"
        "assert len(names) >= 60 and need <= set(names) and not bad, \\\n"
        "    (sorted(need - set(names)), bad)\n"
        "assert os.listdir('.') == [] and os.listdir(\n"
        "    tempfile.gettempdir()) == [], (os.listdir('.'),\n"
        "    os.listdir(tempfile.gettempdir()))\n")
    cwd, tmp = tmp_path / "cwd", tmp_path / "tmp"
    cwd.mkdir()
    tmp.mkdir()
    subprocess.run([sys.executable, "-c", code], check=True, cwd=cwd,
                   env=dict(os.environ, PYTHONPATH=REPO, TMPDIR=str(tmp)))
