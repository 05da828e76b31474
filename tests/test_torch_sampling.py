"""Port parity: sampling from a trained generator (gantron_tpu_torch's
eval/sampling.py, eval/study.compute_wavs, utils/audio_tools.mel_to_audio,
Synthesizer.from_checkpoint, the WaveGlow checkpoint loader and the two
CLIs) against the JAX package's, at tiny sizes.

Weights are carried over from the JAX package (utils/jax_weights.py);
prenet dropout is off on both sides and styles are injected, so the decodes
are deterministic. Where a function draws with its own random stream
(Griffin-Lim phases, WaveGlow latents), names, lengths and shapes are
compared, not samples.
"""

import functools
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import gantron_tpu.models.tacotron2 as jax_taco
import gantron_tpu.eval.sampling as jax_sampling
from gantron_tpu.eval.study import compute_wavs as jax_compute_wavs
from gantron_tpu.models import waveglow as jw
from gantron_tpu.utils.audio_tools import mel_to_audio as jax_mel_to_audio
from gantron_tpu_torch.config import HParams
from gantron_tpu_torch.data.wav import read_wav
from gantron_tpu_torch.eval import sampling
from gantron_tpu_torch.eval.study import compute_wavs
from gantron_tpu_torch.models import waveglow as pw
from gantron_tpu_torch.train.checkpoint import CheckpointManager
from gantron_tpu_torch.tts import Synthesizer
from gantron_tpu_torch.utils.audio_tools import mel_to_audio
from gantron_tpu_torch.models.discriminator import make_discriminator
from gantron_tpu_torch.train.state import wrap_models
from gantron_tpu_torch.utils.jax_weights import tacotron2_from_jax
from gantron_tpu_torch.utils.loading import (load_discriminator,
                                             load_generator)
from test_torch_tacotron2 import (_randomise_bn, no_jax_dropout,  # noqa: F401
                                  port_model, tiny_hparams)
from test_torch_waveglow import small_cfg
from test_waveglow import _nvidia_style_state_dict
from torch_threads import one_torch_thread  # noqa: F401

TEXT_IDS = np.array([[5, 12, 30, 7, 19, 44, 3]], np.int64)


@functools.lru_cache(maxsize=None)
def jax_init(use_noise, seed=4, **over):
    """(JAX hparams, port hparams, the JAX Tacotron2, fresh weights with
    numpy leaves) at the tiny shapes, with or without noise."""
    jhp, hp = (tiny_hparams(**over) if use_noise
               else tiny_hparams(use_noise=False, noise_size=0, **over))
    model = jax_taco.Tacotron2(jhp)
    return jhp, hp, model, jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda r: model.init(
            r, np.ones((2, 8), np.int32), np.full((2,), 8, np.int32),
            np.zeros((2, jhp.n_mel_channels, 4), np.float32),
            np.zeros((2,), np.int32), np.zeros((2, 5), np.float32),
            np.full((2,), 4, np.int32), train=False))(
        {"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(1),
         "noise": jax.random.PRNGKey(2)}))


@pytest.mark.parametrize("B,T", [(1, 9), (2, 9), (3, 14), (5, 6)])
def test_pairwise_sample_distance_matches_jax(B, T):
    rng = np.random.RandomState(B * 10 + T)
    mels = rng.normal(0, 1, (B, 4, T)).astype(np.float32)
    lengths = rng.randint(0, T + 1, B)
    assert sampling.pairwise_sample_distance(mels, lengths) == \
        jax_sampling.pairwise_sample_distance(mels, lengths)


@pytest.mark.parametrize("n_groups,int_emotions,predefined",
                         [(6, True, False), (3, True, False),
                          (5, False, True), (2, False, True)])
def test_group_emotions_match_jax(n_groups, int_emotions, predefined):
    """The draw-free branches are equal; a draw has JAX's shape and
    range."""
    got = sampling.group_emotions(n_groups, int_emotions, predefined,
                                  torch.Generator().manual_seed(0))
    want = jax_sampling.group_emotions(n_groups, int_emotions, predefined,
                                       jax.random.PRNGKey(0))
    np.testing.assert_array_equal(got, want)
    drawn = sampling.group_emotions(n_groups + 1, False, False,
                                    torch.Generator().manual_seed(0))
    assert drawn.shape == (n_groups + 1, 5) and drawn.dtype == np.float32
    assert (0 <= drawn).all() and (drawn < 1).all()


@pytest.mark.parametrize("force_style,simple_name,int_emotions", [
    (True, False, True), (False, True, True)])
def test_force_style_emotions_matches_jax(no_jax_dropout, tmp_path,
                                          force_style, simple_name,
                                          int_emotions):
    """The same files (names, one mel each) and the same cap count as the
    JAX package's, with the JAX call's per-group styles injected into the
    port's (without forced styles, a configuration without noise, so that
    nothing is drawn) and the emotions forced (integer combinations) or
    not."""
    jhp, hp, model, variables = jax_init(force_style)
    key = jax.random.PRNGKey(3)
    kw = dict(force_emotions=int_emotions, force_style=force_style,
              style_shape=[TEXT_IDS.shape[1], hp.noise_size], n_groups=2,
              n_samples_styles=2, simple_name=simple_name,
              int_emotions=int_emotions, max_decoder_steps=8)
    j_dir, p_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    j_count = jax_sampling.force_style_emotions(
        model, variables, jnp.asarray(TEXT_IDS, jnp.int32),
        j_dir, key=key, **kw)
    # The per-group styles the JAX call drew (its second key).
    styles = np.asarray(jax.random.uniform(jax.random.split(key, 3)[1],
                                           (2, 1, hp.noise_size)))
    p_count = sampling.force_style_emotions(
        port_model(variables, hp), TEXT_IDS, p_dir, styles=styles, **kw)
    assert p_count == j_count
    names = sorted(os.listdir(j_dir))
    assert sorted(os.listdir(p_dir)) == names and len(names) == 4
    for n in names:
        np.testing.assert_allclose(np.load(os.path.join(p_dir, n)),
                                   np.load(os.path.join(j_dir, n)),
                                   atol=1e-4)


def test_random_style_matches_jax(no_jax_dropout):
    """Without noise (nothing drawn), the port's free samples are JAX's
    random_style samples: mels and lengths."""
    jhp, hp, model, variables = jax_init(False)
    mels, lengths = jax_sampling.random_style(
        model, variables, jnp.asarray(TEXT_IDS, jnp.int32), 0, 3,
        key=jax.random.PRNGKey(1), max_decoder_steps=8)
    p_mels, p_lengths = sampling.random_style(
        port_model(variables, hp), TEXT_IDS, 3, max_decoder_steps=8)
    np.testing.assert_array_equal(p_lengths, lengths)
    np.testing.assert_allclose(p_mels, mels, atol=1e-4)


@pytest.mark.parametrize("layout", ["plain", "weight_norm", "legacy_cond",
                                    "payload_model"])
def test_load_waveglow_matches_jax_conversion(tmp_path, layout):
    """A synthetic NVIDIA-layout state_dict saved with torch.save (bare, or
    under "model"; weight-normed convs; per-layer conditioning) loads into
    the port's WaveGlow, which vocodes as the JAX WaveGlow of the JAX
    converter does, with the same latents."""
    cfg_j, cfg_p = small_cfg(jw.WaveGlowConfig), small_cfg(pw.WaveGlowConfig)
    sd = _nvidia_style_state_dict(cfg_j, seed=4)
    rng = np.random.RandomState(5)
    if layout == "weight_norm":
        for k in [k for k in sd if k.startswith("WN.") and
                  k.endswith(".weight")]:
            sd[k[:-len("weight")] + "weight_v"] = sd.pop(k)
            sd[k[:-len("weight")] + "weight_g"] = rng.uniform(
                0.5, 1.5, (sd[k[:-len("weight")] + "weight_v"].shape[0], 1,
                           1)).astype(np.float32)
    if layout == "legacy_cond":
        for k in range(cfg_j.n_flows):
            w = sd.pop(f"WN.{k}.cond_layer.weight")
            b = sd.pop(f"WN.{k}.cond_layer.bias")
            n = 2 * cfg_j.n_channels
            for i in range(cfg_j.n_layers):
                sd[f"WN.{k}.cond_layers.{i}.weight"] = w[i * n:(i + 1) * n]
                sd[f"WN.{k}.cond_layers.{i}.bias"] = b[i * n:(i + 1) * n]
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    path = str(tmp_path / "waveglow.pt")
    torch.save({"model": tensors} if layout == "payload_model" else tensors,
               path)
    port = pw.load_waveglow(path, cfg_p, device="cpu")
    ref = jw.WaveGlow(cfg_j, jw.convert_torch_state_dict(sd, cfg_j))
    T = 6
    mel = rng.normal(-4, 1, (2, cfg_j.n_mel_channels, T)).astype(np.float32)
    z = [rng.normal(0, 1, (2,) + s).astype(np.float32)
         for s in ref.z_shapes(T)]
    want = np.asarray(ref.infer(jnp.asarray(mel), 0.666,
                                z=[jnp.asarray(zi) for zi in z]))
    got = port.infer(torch.from_numpy(mel), 0.666,
                     z=[torch.from_numpy(zi) for zi in z]).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_synthesizer_from_checkpoint_decodes_as_jax(no_jax_dropout,
                                                    tmp_path):
    """A checkpoint written by the port's CheckpointManager around the JAX
    weights loads back (generator, with its BatchNorm statistics, and
    discriminator), and ``Synthesizer.from_checkpoint`` decodes what the JAX
    Synthesizer decodes on those weights."""
    from gantron_tpu.tts import Synthesizer as JaxSynthesizer

    jhp, hp, model, variables = jax_init(True, max_decoder_steps=10)
    variables = jax.tree_util.tree_map(np.copy, variables)
    _randomise_bn(variables["params"], variables["batch_stats"],
                  np.random.RandomState(5))
    G = tacotron2_from_jax(variables["params"], variables["batch_stats"], hp,
                           device="cpu")
    state = wrap_models(hp, G, make_discriminator(hp, device="cpu"), 0)[0]
    path = CheckpointManager(str(tmp_path)).save(state, 3, 0.5)
    for a, b in ((load_generator(path, hp, "cpu"), G),
                 (load_discriminator(path, hp, "cpu"), state.d_model)):
        for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(x, y), k
    synth = Synthesizer.from_checkpoint(path, hp, device="cpu")
    synth.model.decoder.prenet_dropout = False
    style = np.random.RandomState(0).rand(1, 1, hp.noise_size) \
        .astype(np.float32)
    ref = JaxSynthesizer(model, variables, jhp)
    j_mel, j_len = ref.infer_mel(TEXT_IDS[0].astype(np.int32), style=style)
    p_mel, p_len = synth.infer_mel(TEXT_IDS[0], style=torch.from_numpy(style))
    assert p_len == j_len
    np.testing.assert_allclose(p_mel.numpy(), j_mel, atol=1e-4)


def _write_mels(d, hp, lengths, seed=0):
    rng = np.random.RandomState(seed)
    os.makedirs(d, exist_ok=True)
    for i, L in enumerate(lengths):
        np.save(os.path.join(d, f"{i}-0.6,0.npy"),
                rng.normal(-5, 1, (hp.n_mel_channels, L)).astype(np.float32))


def test_compute_wavs_and_mel_to_audio_match_jax_files(tmp_path):
    """Griffin-Lim vocoding of a folder of mels (names with dots in them,
    one shorter than an STFT window, batches of 2 with a remainder): the
    port writes JAX's wav files at JAX's lengths; wavs already present are
    kept by compute_wavs and redone by mel_to_audio only when forced."""
    from gantron_tpu.config import HParams as JaxHParams

    over = dict(filter_length=256, hop_length=64, win_length=256,
                n_mel_channels=20, sampling_rate=8000, mel_fmax=4000.0)
    jhp, hp = JaxHParams(), HParams()
    jhp.add_params(over)
    hp.add_params(over)
    lengths = [12, 3, 7]
    mels = str(tmp_path / "mels")
    _write_mels(mels, hp, lengths)
    out = {}
    for side, fn, kw in (("jax", jax_compute_wavs, {}),
                         ("port", compute_wavs, {"device": "cpu"})):
        d = str(tmp_path / side)
        paths = fn(mels, d, hp if side == "port" else jhp, batch_size=2,
                   **kw)
        out[side] = {os.path.basename(p): read_wav(p)[0].shape
                     for p in paths}
        assert [os.path.basename(p) for p in paths] == sorted(out[side])
    assert out["port"] == out["jax"] and len(out["port"]) == 3
    kept = compute_wavs(mels, str(tmp_path / "port"), hp, device="cpu")
    assert len(kept) == 3

    for side, fn, kw in (("jax", jax_mel_to_audio, {}),
                         ("port", mel_to_audio, {"device": "cpu"})):
        d = str(tmp_path / f"m2a_{side}")
        _write_mels(d, hp, lengths[:1], seed=1)
        written = fn(d, randomize=False, hp=jhp if side == "jax" else hp,
                     **kw)
        out[side] = sorted((os.path.basename(p), read_wav(p)[0].shape)
                           for p in written)
        assert fn(d, randomize=False, hp=hp if side == "port" else jhp,
                  **kw) == []
    assert out["port"] == out["jax"] and len(out["port"]) == 1


TINY_CLI = ("symbols_embedding_dim=32,encoder_embedding_dim=32,"
            "encoder_n_convolutions=2,attention_rnn_dim=48,decoder_rnn_dim=48,"
            "prenet_dim=16,attention_dim=24,attention_location_n_filters=4,"
            "attention_location_kernel_size=7,postnet_embedding_dim=32,"
            "postnet_n_convolutions=3,discriminator_dim=32,"
            "max_decoder_steps=10,use_noise=True,noise_size=8,"
            "use_labels=False,batch_size=4,iterations=3,"
            "iters_per_checkpoint=3,validation_audio=False,"
            "text_buckets=[16],mel_buckets=[40]")


@pytest.mark.parametrize("over", [
    {}, dict(use_noise=False, noise_size=0),
    dict(vesus_path="/v", use_labels=True, use_intended_labels=True),
    dict(vesus_path="/v", use_labels=False, encoder_inputs=True,
         discriminator_type="linear")])
def test_build_run_name_matches_train_py(over):
    import train as jax_train_cli
    from gantron_tpu.config import HParams as JaxHParams
    from gantron_tpu_torch.cli.train import build_run_name

    jhp, hp = JaxHParams(), HParams()
    jhp.add_params(over)
    hp.add_params(over)
    assert build_run_name(hp) == jax_train_cli.build_run_name(jhp)


def test_cli_trains_then_samples(tmp_path):
    """``python -m gantron_tpu_torch.cli.train`` (in-process, on the CPU)
    writes the JAX CLI's run layout (``<run name>.metrics.jsonl`` and an
    ``iter=3_val-loss=*.ckpt`` with its sidecar); ``Synthesizer.
    from_checkpoint`` serves that checkpoint, and ``cli.inference_samples``
    reads it and writes random-style mels with their wavs, and forced-style
    groups named as the JAX function names them."""
    import train as jax_train_cli
    from gantron_tpu.config import HParams as JaxHParams
    from gantron_tpu_torch.cli import inference_samples
    from gantron_tpu_torch.cli import train as train_cli

    out = str(tmp_path / "run")
    state, iteration = train_cli.main(
        ["--wavs_path", "synthetic", "--hparams", TINY_CLI, "-o", out,
         "--device", "cpu", "--n_gpus", "1", "--rank", "0"])
    jhp = JaxHParams.create(TINY_CLI)
    name = jax_train_cli.build_run_name(jhp)
    assert iteration == state.step == 3
    files = sorted(os.listdir(out))
    assert f"{name}.metrics.jsonl" in files
    ckpt = CheckpointManager(out).latest()
    assert CheckpointManager.parse_name(ckpt)[0] == 3
    assert os.path.basename(ckpt) + ".meta.json" in files

    hp = HParams.create(TINY_CLI)
    wav = Synthesizer.from_checkpoint(ckpt, hp, device="cpu").tts(
        "Hello.", griffin_lim_iters=2)
    assert wav.ndim == 1 and len(wav) > 0 and np.isfinite(wav).all()

    samples = str(tmp_path / "samples")
    inference_samples.main(["-c", ckpt, "-o", samples, "--samples", "3",
                            "--generate_audio", "--hparams", TINY_CLI,
                            "--device", "cpu"])
    assert sorted(os.listdir(samples)) == [f"{i}.{ext}" for i in range(3)
                                           for ext in ("npy", "wav")]
    mels = [np.load(os.path.join(samples, f"{i}.npy")) for i in range(3)]
    # Griffin-Lim gives (frames - 1) * hop samples of the padded batch.
    longest = max(max(m.shape[1] for m in mels), 1024 // 256 + 1)
    for i, mel in enumerate(mels):
        wav, _ = read_wav(os.path.join(samples, f"{i}.wav"))
        assert mel.shape[0] == 80 and 0 < mel.shape[1] <= 10
        assert np.isfinite(mel).all() and np.isfinite(wav).all()
        assert len(wav) == min(mel.shape[1], longest - 1) * 256

    forced = str(tmp_path / "forced")
    inference_samples.main(["-c", ckpt, "-o", forced, "--force",
                            "--hparams", TINY_CLI, "--device", "cpu"])
    want = sorted(f"style-{g}-{i}.npy" for g in range(6) for i in range(20))
    assert sorted(os.listdir(forced)) == want


def test_new_entry_points_default_to_the_card(tmp_path):
    """Without a card, the slice's entry points raise at their default
    device instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    from gantron_tpu_torch.train.loop import make_vocoder, train

    _, hp = tiny_hparams()
    mels = str(tmp_path / "mels")
    _write_mels(mels, hp, [6])
    ckpt = str(tmp_path / "x.ckpt")
    for make in (lambda: train(str(tmp_path / "run"), None, False, hp,
                               "synthetic"),
                 lambda: make_vocoder(hp),
                 lambda: compute_wavs(mels, str(tmp_path / "w"), hp),
                 lambda: mel_to_audio(mels, hp=hp),
                 lambda: load_generator(ckpt, hp),
                 lambda: Synthesizer.from_checkpoint(ckpt, hp)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
