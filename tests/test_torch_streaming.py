"""Port parity of streaming synthesis: gantron_tpu_torch's segmented decode
(``Decoder.infer_segment``) against the JAX package's, the port's stream
against its own offline decode, and the behaviours that
tests/test_streaming.py holds the JAX ``StreamingSynthesizer`` to.

The segment parity uses test_torch_tacotron2's weights and conventions:
prenet dropout off on both sides, injected style, and a gate threshold with
a clean margin so that stops fall at different steps and compare exactly.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import gantron_tpu.models.tacotron2 as jax_taco
from gantron_tpu_torch.models.tacotron2 import Tacotron2
from gantron_tpu_torch.models.waveglow import (WaveGlow, WaveGlowConfig,
                                               random_params)
from gantron_tpu_torch.tts import StreamingSynthesizer, Synthesizer
from test_torch_tacotron2 import (jax_variables, no_jax_dropout,  # noqa: F401
                                 pick_gate_threshold, port_model, texts,
                                 tiny_hparams, variables_for)
from torch_threads import one_torch_thread  # noqa: F401

CAP = 24
TEXT = "Streaming speech, one chunk at a time."


@pytest.mark.parametrize("quantized,K", [(q, K) for q in (False, True)
                                         for K in (1, 2)])
def test_infer_segment_matches_jax(jax_variables, no_jax_dropout,
                                   quantized, K):
    """The port's segments of 1, 7 and 24 steps against the JAX package's
    7-step segments (whose stream is segment-size invariant): every carry
    at a JAX segment boundary, the mel, gate and alignment streams, the
    lengths and the stop flag, f32 atol 1e-5."""
    jhp, hp = tiny_hparams(quantized_inference=quantized,
                           n_frames_per_step=K, max_decoder_steps=CAP)
    variables = variables_for(jax_variables, K)
    model = jax_taco.Tacotron2(jhp)
    port = port_model(variables, hp)
    lengths = np.array([9, 5, 7], np.int32)
    ids = texts(hp, lengths, 9)
    style = np.random.RandomState(6).rand(3, 1, hp.noise_size) \
        .astype(np.float32)
    hp.gate_threshold = 1.0  # never stops: the gate energies alone
    energies = port.infer(torch.from_numpy(ids), torch.from_numpy(style),
                          text_lengths=torch.from_numpy(lengths))[2][:, ::K]
    hp.gate_threshold = jhp.gate_threshold = pick_gate_threshold(
        energies.numpy())

    j_mem = model.apply(variables, jnp.asarray(ids), jnp.asarray(style),
                        text_lengths=jnp.asarray(lengths),
                        method=model.encode_memory,
                        rngs={"dropout": jax.random.PRNGKey(0)})[0]
    j_seg = jax.jit(lambda m, c: model.apply(
        variables, m, c, 7, jax.random.PRNGKey(1),
        memory_lengths=jnp.asarray(lengths), method=model.decode_segment))
    carry = model.apply(variables, j_mem, CAP, method=model.decode_init)
    j_carries, j_outs = [], []
    for _ in range(4):  # 28 steps
        carry, *out = j_seg(j_mem, carry)
        j_carries.append(jax.tree_util.tree_map(np.asarray, carry))
        j_outs.append([np.asarray(o) for o in out])
    j_mel = np.concatenate([o[0] for o in j_outs], axis=2)
    j_gate = np.concatenate([o[1] for o in j_outs], axis=1)
    j_attn = np.concatenate([o[2] for o in j_outs], axis=1)
    assert (j_outs[-1][3] < CAP * K).all() and j_outs[-1][4]
    assert len(set(j_outs[-1][3].tolist())) > 1, "stops at one step only"

    p_mem = port.encode_memory(torch.from_numpy(ids),
                               torch.from_numpy(style),
                               text_lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(p_mem.numpy(), np.asarray(j_mem), atol=1e-5)
    inputs = port.decoder.open_loop_inputs(p_mem, torch.from_numpy(lengths))
    for chunk in (1, 7, 24):
        carry = port.decoder.infer_init(p_mem, CAP)
        mels, gates, attns, steps = [], [], [], 0
        while steps < 28:
            carry, mel, gate, attn, mel_lengths, done = \
                port.decoder.infer_segment(p_mem, carry, None, chunk, inputs)
            steps += chunk
            mels.append(mel)
            gates.append(gate)
            attns.append(attn)
            if steps % 7 == 0 and steps <= 28:
                j_carry = j_carries[steps // 7 - 1]
                state, prev, finished, length, t = carry
                for a, b in zip(state + (prev,), j_carry[0] + (j_carry[1],)):
                    np.testing.assert_allclose(a.numpy(), b, atol=1e-5,
                                               err_msg=f"chunk {chunk}")
                np.testing.assert_array_equal(finished.numpy(), j_carry[2])
                np.testing.assert_array_equal(length.numpy(), j_carry[3])
                assert t == int(j_carry[4]) == steps
                np.testing.assert_array_equal(
                    mel_lengths.numpy(), j_outs[steps // 7 - 1][3])
                assert bool(done) == bool(j_outs[steps // 7 - 1][4])
        n = 28 * K
        for a, b, label in ((torch.cat(mels, 2)[..., :n], j_mel, "mel"),
                            (torch.cat(gates, 1)[:, :n], j_gate, "gate"),
                            (torch.cat(attns, 1)[:, :28], j_attn,
                             "alignments")):
            np.testing.assert_allclose(a.numpy(), b, atol=1e-5,
                                       err_msg=f"{label}, chunk {chunk}")


def port_synth(hp, seed=1, **kw):
    model = Tacotron2(hp, device="cpu", seed=seed)
    return (Synthesizer(hp, model, device="cpu"),
            StreamingSynthesizer(hp, model, device="cpu", **kw))


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("stop", ["gate", "cap"])
def test_stream_equals_offline_decode_at_any_chunk(quantized, stop):
    """With prenet dropout on, the streamed decoder mel is bit-equal to
    ``Synthesizer.infer``'s for the same seed, for one text and for a
    ragged batch, at every chunk size (so the stream is chunk-size
    invariant); stopping at the gate mid-chunk or at a cap that is no chunk
    multiple."""
    _, hp = tiny_hparams(quantized_inference=quantized, max_decoder_steps=23,
                         gate_threshold=1.0)
    synth, _ = port_synth(hp)
    batch = texts(hp, [9, 5, 7], 9)
    if stop == "gate":
        energies = synth.infer(batch, seed=4, early_exit=False)[2]
        hp.gate_threshold = pick_gate_threshold(energies.numpy())
    streamer = StreamingSynthesizer(hp, synth.model, lookback=2,
                                    griffin_lim_iters=1, device="cpu")
    for text in (TEXT, batch):
        ref = synth.infer(text, seed=4)
        L = ref[4]
        assert (L < 23).all() if stop == "gate" else (L == 23).all()
        for chunk in (1, 5, 40):
            streamer.chunk = chunk
            wav, lengths, _, _ = streamer.synthesize(text, seed=4)
            n = streamer.last_mel.shape[2]
            assert n >= int(L.max())
            assert torch.equal(streamer.last_mel, ref[0][:, :, :n]), chunk
            np.testing.assert_array_equal(lengths, L.numpy())
            assert wav.shape == (len(L), int(L.max()) * hp.hop_length)


def test_streaming_synthesize_ttfa_and_shape():
    _, hp = tiny_hparams(max_decoder_steps=24, gate_threshold=1.0)
    _, synth = port_synth(hp, chunk=8, lookback=4, crossfade=64,
                          griffin_lim_iters=2)
    ids = texts(hp, [8], 8)
    chunks = list(synth.stream(ids, seed=0))
    assert len(chunks) >= 2  # streamed, not monolithic
    total = sum(c.shape[1] for c in chunks)
    assert total == 24 * hp.hop_length
    assert all(c.dtype == np.float32 for c in chunks)
    wav, lengths, ttfa, total_s = synth.synthesize(ids, seed=0)
    assert wav.ndim == 2 and wav.shape[0] == 1
    assert 0 < ttfa <= total_s
    assert wav.shape[1] == int(lengths.max()) * hp.hop_length


@pytest.mark.parametrize("cap", [16, 20])
def test_streaming_stops_at_the_cap_and_never_emits_past_it(cap):
    """The gate never fires: the stream ends at the cap, also when the cap
    is no chunk multiple (the last segment decodes only up to the cap), and
    only cap-worth of audio is emitted."""
    _, hp = tiny_hparams(max_decoder_steps=cap, gate_threshold=1.0)
    _, synth = port_synth(hp, chunk=8, lookback=4, crossfade=0,
                          griffin_lim_iters=2)
    chunks = list(synth.stream(texts(hp, [8], 8), seed=1))
    assert sum(c.shape[1] for c in chunks) == cap * hp.hop_length
    assert int(synth.last_lengths.max()) == cap
    assert synth.last_mel.shape[2] == cap


def test_streaming_griffin_lim_requires_lookback():
    _, hp = tiny_hparams()
    with pytest.raises(ValueError, match="lookback"):
        StreamingSynthesizer(hp, Tacotron2(hp, device="cpu"), lookback=0,
                             device="cpu")


def test_streaming_accepts_conditioning():
    """A label-conditioned model streams with the caller's emotions: the
    same emotions give the same audio, others give other audio."""
    _, hp = tiny_hparams(use_labels=True, use_intended_labels=True,
                         vesus_path="x", max_decoder_steps=16,
                         gate_threshold=1.0)
    _, synth = port_synth(hp, chunk=8, lookback=4, crossfade=0,
                          griffin_lim_iters=2)
    ids = texts(hp, [8], 8)
    e1 = torch.tensor([[1.0, 0, 0, 0, 0]])
    e2 = torch.tensor([[0, 0, 0, 0, 1.0]])
    spk = torch.zeros(1, dtype=torch.long)
    a1 = synth.synthesize(ids, seed=0, emotions=e1, speaker=spk)[0]
    a2 = synth.synthesize(ids, seed=0, emotions=e1, speaker=spk)[0]
    b = synth.synthesize(ids, seed=0, emotions=e2, speaker=spk)[0]
    np.testing.assert_array_equal(a1, a2)
    assert not np.array_equal(a1, b)


def test_streaming_lookback_zero_with_waveglow():
    """lookback=0 keeps an empty tail (``window[..., -0:]`` would be the
    whole window): the stream emits constant-width chunks that tile the
    cap."""
    _, hp = tiny_hparams(max_decoder_steps=8, n_mel_channels=8,
                         hop_length=8, gate_threshold=1.0)
    cfg = WaveGlowConfig(n_mel_channels=8, n_flows=2, n_group=4,
                         n_early_every=4, n_early_size=1, n_layers=1,
                         n_channels=8, kernel_size=3, upsample_kernel=16,
                         upsample_stride=8)
    wg = WaveGlow(cfg, random_params(torch.Generator().manual_seed(0), cfg),
                  device="cpu")
    _, synth = port_synth(hp, waveglow=wg, chunk=4, lookback=0, crossfade=0)
    chunks = list(synth.stream(texts(hp, [8], 8), seed=1))
    assert len(chunks) == 2
    assert all(c.shape == (1, 4 * hp.hop_length) for c in chunks)
    assert all(np.isfinite(c).all() for c in chunks)


def test_streaming_silences_post_stop_frames():
    """Frames between a sample's stop and the chunk's end vocode as noise
    (zero log-mels): the stream emits silence there."""
    _, hp = tiny_hparams(max_decoder_steps=16, gate_threshold=0.0)
    _, synth = port_synth(hp, chunk=8, lookback=2, crossfade=0,
                          griffin_lim_iters=2)
    chunks = list(synth.stream(texts(hp, [8], 8), seed=0))
    assert len(chunks) == 1  # finished in the first chunk
    wav = chunks[0]
    assert int(synth.last_lengths[0]) == 1
    assert np.any(wav[0, :hp.hop_length] != 0.0)
    np.testing.assert_array_equal(wav[0, hp.hop_length:], 0.0)


def test_streaming_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    _, hp = tiny_hparams()
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingSynthesizer(hp)
