"""Port parity of the conditioned configurations (BASELINE.md configs 2-4 and
``encoder_inputs``): VESUS speakers with noise, labels only, labels with
noise, and labels with noise on the encoder side. The port's Tacotron2 holds
the JAX model's weights (utils/jax_weights.py); speaker ids in [0, 123) and
emotions come from numpy, and the style is injected on both sides.

Held against JAX: ``encode_memory`` and the teacher-forced forward in all
four configurations; ``infer`` (prenet dropout off, the gate threshold picked
as tests/test_torch_tacotron2.py picks it, float32 and int8 recurrence
matrices) in all four. With labels and no emotions given, both packages draw
them, and threefry cannot match Philox: there the port is held to drawing
U[0, 1) of shape (B, 5) from its noise generator, reproducibly. One G step
and one D step from a JAX state are held in
tests/test_torch_conditioned_steps.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import gantron_tpu.models.tacotron2 as jax_taco
from gantron_tpu_torch.models.modules import disable_dropout
from gantron_tpu_torch.models.tacotron2 import N_EMOTIONS, N_SPEAKERS
from gantron_tpu_torch.utils.jax_weights import tacotron2_from_jax
from test_torch_tacotron2 import (_randomise_bn,
                                  no_jax_dropout,  # noqa: F401
                                  pick_gate_threshold, port_model, texts,
                                  tiny_hparams)
from torch_threads import one_torch_thread  # noqa: F401

VESUS = dict(vesus_path="vesus", speakers_embedding=6)
CONFIGS = {
    "vesus_noise": dict(VESUS, use_labels=False, use_noise=True),
    "labels": dict(VESUS, use_labels=True, use_noise=False),
    "labels_noise": dict(VESUS, use_labels=True, use_noise=True),
    "encoder_inputs": dict(VESUS, use_labels=True, use_noise=True,
                           encoder_inputs=True),
}
LENGTHS = np.array([9, 5, 7], np.int32)


_JAX_WEIGHTS = {}


def init_jax_weights(jhp):
    """JAX Tacotron2 weights (numpy leaves) for ``jhp``, with non-trivial
    BatchNorm and the gate readout scaled up so that its energy moves by
    more than the threshold margin from step to step. ``init`` runs jitted
    (one compile instead of one a primitive), once a configuration in a
    process; every caller gets its own copy."""
    key = repr(jhp)
    if key not in _JAX_WEIGHTS:
        model = jax_taco.Tacotron2(jhp)
        B, T = 2, 8
        v = jax.jit(model.init, static_argnames=("train",))(
            {"params": jax.random.PRNGKey(0),
             "dropout": jax.random.PRNGKey(1),
             "noise": jax.random.PRNGKey(2)},
            jnp.ones((B, T), jnp.int32), jnp.full((B,), T, jnp.int32),
            jnp.zeros((B, jhp.n_mel_channels, 4)), jnp.zeros((B,), jnp.int32),
            jnp.zeros((B, 5)), jnp.full((B,), 4, jnp.int32), train=False)
        v = jax.tree_util.tree_map(np.array, jax.device_get(v))
        v = {"params": v["params"], "batch_stats": v["batch_stats"]}
        _randomise_bn(v["params"], v["batch_stats"],
                      np.random.RandomState(5))
        v["params"]["decoder"]["gate_w"] = \
            v["params"]["decoder"]["gate_w"] * 30.0
        _JAX_WEIGHTS[key] = v
    return jax.tree_util.tree_map(np.copy, _JAX_WEIGHTS[key])


@pytest.fixture(scope="module")
def jax_weights():
    return {name: init_jax_weights(tiny_hparams(**over)[0])
            for name, over in CONFIGS.items()}


def conditioning(hp, B, seed):
    """(style (B, 1, noise_size) or None, emotions (B, 5), speaker ids (B,))
    from numpy."""
    rng = np.random.RandomState(seed)
    style = (rng.rand(B, 1, hp.noise_size).astype(np.float32)
             if hp.use_noise else None)
    return (style, rng.rand(B, N_EMOTIONS).astype(np.float32),
            rng.randint(0, N_SPEAKERS, B).astype(np.int32))


def _t(x, dtype=None):
    return None if x is None else torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_encode_memory_matches_jax(jax_weights, config):
    jhp, hp = tiny_hparams(**CONFIGS[config])
    variables = jax_weights[config]
    ids = texts(hp, LENGTHS, 9)
    style, emotions, speaker = conditioning(hp, 3, 1)
    model = jax_taco.Tacotron2(jhp)
    j_mem = model.apply(
        variables, jnp.asarray(ids),
        None if style is None else jnp.asarray(style), jnp.asarray(emotions),
        jnp.asarray(speaker), text_lengths=jnp.asarray(LENGTHS),
        method=model.encode_memory,
        rngs={"dropout": jax.random.PRNGKey(0)})[0]
    port = port_model(variables, hp)
    p_mem = port.encode_memory(
        torch.from_numpy(ids), _t(style), _t(emotions),
        _t(speaker, torch.long),
        text_lengths=torch.from_numpy(LENGTHS))
    assert p_mem.shape == (3, 9, port.memory_dim) == j_mem.shape
    np.testing.assert_allclose(p_mem.numpy(), np.asarray(j_mem), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_teacher_forced_forward_matches_jax(jax_weights, no_jax_dropout,
                                            config):
    """Train-mode forward (batch-statistics BatchNorm), dropout off."""
    jhp, hp = tiny_hparams(**CONFIGS[config])
    variables = jax_weights[config]
    rng = np.random.RandomState(4)
    B, T_out = 3, 12
    ids = texts(hp, LENGTHS, 9, seed=4)
    output_lengths = np.array([12, 7, 10], np.int32)
    mels = (rng.randn(B, hp.n_mel_channels, T_out) * 0.5).astype(np.float32)
    for b in range(B):
        mels[b, :, output_lengths[b]:] = 0
    style, emotions, speaker = conditioning(hp, B, 2)
    model = jax_taco.Tacotron2(jhp)
    j_out, _ = model.apply(
        variables, jnp.asarray(ids), jnp.asarray(LENGTHS), jnp.asarray(mels),
        jnp.asarray(speaker), jnp.asarray(emotions),
        jnp.asarray(output_lengths), train=True,
        style=None if style is None else jnp.asarray(style),
        rngs={"dropout": jax.random.PRNGKey(1)}, mutable=["batch_stats"])
    port = disable_dropout(tacotron2_from_jax(
        variables["params"], variables["batch_stats"], hp, device="cpu"))
    p_out = port(torch.from_numpy(ids).long(),
                 torch.from_numpy(LENGTHS).long(), torch.from_numpy(mels),
                 _t(speaker, torch.long), _t(emotions),
                 torch.from_numpy(output_lengths).long(), train=True,
                 style=_t(style))
    for name, a, b in zip(("mel", "mel_postnet", "gate", "alignments"),
                          p_out, j_out):
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_infer_matches_jax(jax_weights, no_jax_dropout, config, quantized):
    """A padded batch of three, every sample stopping on its gate: lengths
    exact, mels, gates and alignments within 1e-4."""
    jhp, hp = tiny_hparams(quantized_inference=quantized, **CONFIGS[config])
    variables = jax_weights[config]
    model = jax_taco.Tacotron2(jhp)
    port = port_model(variables, hp)
    ids = texts(hp, LENGTHS, 9)
    style, emotions, speaker = conditioning(hp, 3, 3)

    def run_port():
        out = port.infer(torch.from_numpy(ids), _t(style), _t(emotions),
                         _t(speaker, torch.long),
                         text_lengths=torch.from_numpy(LENGTHS))
        return [o.numpy() for o in out]

    hp.gate_threshold = 1.0  # never stops: the gate energies alone
    energies = run_port()[2]
    hp.gate_threshold = jhp.gate_threshold = pick_gate_threshold(energies)
    j = model.apply(
        variables, jnp.asarray(ids),
        None if style is None else jnp.asarray(style), jnp.asarray(emotions),
        jnp.asarray(speaker), None, False, method=model.infer,
        text_lengths=jnp.asarray(LENGTHS),
        rngs={"dropout": jax.random.PRNGKey(7),
              "noise": jax.random.PRNGKey(8)})
    p = run_port()
    for label, a, b in zip(("mel", "mel_postnet", "gate", "alignments"),
                           p[:4], j[:4]):
        assert a.shape == b.shape, label
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4,
                                   err_msg=label)
    np.testing.assert_array_equal(p[4], np.asarray(j[4]))
    assert (p[4] < hp.max_decoder_steps).all()
    assert len(set(p[4].tolist())) > 1, "stops at one step only"


def test_labels_without_emotions_draw_them_from_the_noise_generator():
    """``emotions=None`` with labels: U[0, 1) of shape (B, 5) drawn from
    the noise generator (the first draw of ``encode_memory``), the same
    under the same seed."""
    _, hp = tiny_hparams(**CONFIGS["labels"])
    from gantron_tpu_torch.models.tacotron2 import Tacotron2

    model = Tacotron2(hp, device="cpu", seed=1)
    ids = torch.from_numpy(texts(hp, LENGTHS, 9)).long()
    seen = []
    real_cat = model._memory_side_concat

    def spy(outputs, speaker_ids, emotions, *rest):
        seen.append(emotions)
        return real_cat(outputs, speaker_ids, emotions, *rest)

    model._memory_side_concat = spy
    mems = [model.encode_memory(
        ids, noise_generator=torch.Generator().manual_seed(s))
        for s in (3, 3, 4)]
    expected = torch.rand((3, N_EMOTIONS),
                          generator=torch.Generator().manual_seed(3))
    assert seen[0].shape == (3, N_EMOTIONS)
    assert torch.equal(seen[0], expected) and torch.equal(seen[1], expected)
    assert ((seen[2] >= 0) & (seen[2] < 1)).all()
    assert not torch.equal(seen[2], expected)
    assert torch.equal(mems[0], mems[1]) and not torch.equal(mems[0],
                                                             mems[2])
