"""Port parity: gantron_tpu_torch's Tacotron2 inference half against the JAX
package's, with the same weights carried over (utils/jax_weights.py).

Inputs are made with numpy from a seed and given to both sides; the style is
injected and prenet dropout is off on both (the JAX side by monkeypatching
its ``_dropout``, the port by its switch). BatchNorm scale, shift and running
statistics are randomised so that their conversion is exercised.

The gate threshold of each decode is chosen from the port's own gate
energies (``pick_gate_threshold``) so that every sample stops, at different
steps where the batch allows, with every energy before a stop at least 1e-2
from the threshold: float32 drift of ~1e-6 cannot flip a stop decision, and
lengths are compared exactly.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import gantron_tpu.models.tacotron2 as jax_taco
from gantron_tpu.config import HParams as JaxHParams
from gantron_tpu_torch.config import HParams
from gantron_tpu_torch.utils.jax_weights import tacotron2_from_jax
from torch_threads import one_torch_thread  # noqa: F401

TINY = dict(
    symbols_embedding_dim=32, encoder_embedding_dim=32,
    encoder_n_convolutions=2, attention_rnn_dim=48, decoder_rnn_dim=48,
    prenet_dim=16, attention_dim=24, attention_location_n_filters=4,
    attention_location_kernel_size=7, postnet_embedding_dim=32,
    postnet_n_convolutions=3, noise_size=8, max_decoder_steps=12,
    use_noise=True, use_labels=False, scan_unroll=1)


def tiny_hparams(**over):
    """The same configuration as (JAX HParams, port HParams)."""
    jhp, hp = JaxHParams(), HParams()
    jhp.add_params({**TINY, **over})
    hp.add_params({**TINY, **over})
    return jhp, hp


def _randomise_bn(params, stats, rng):
    for part in ("encoder", "postnet"):
        for name in list(params[part]):
            if name.startswith("bn_"):
                bn, st = params[part][name]["bn"], stats[part][name]["bn"]
                n = bn["scale"].shape[0]
                bn["scale"] = rng.uniform(0.8, 1.2, n).astype(np.float32)
                bn["bias"] = rng.normal(0, 0.1, n).astype(np.float32)
                st["mean"] = rng.normal(0, 0.1, n).astype(np.float32)
                st["var"] = rng.uniform(0.5, 1.5, n).astype(np.float32)


@pytest.fixture(scope="module")
def jax_variables():
    """JAX Tacotron2 weights (numpy leaves) at K = 1, with non-trivial
    BatchNorm."""
    jhp, _ = tiny_hparams()
    model = jax_taco.Tacotron2(jhp)
    B, T = 2, 8
    v = model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
         "noise": jax.random.PRNGKey(2)},
        jnp.ones((B, T), jnp.int32), jnp.full((B,), T, jnp.int32),
        jnp.zeros((B, jhp.n_mel_channels, 4)), jnp.zeros((B,), jnp.int32),
        jnp.zeros((B, 5)), jnp.full((B,), 4, jnp.int32), train=False)
    v = jax.tree_util.tree_map(np.asarray, jax.device_get(v))
    v = {"params": v["params"], "batch_stats": v["batch_stats"]}
    _randomise_bn(v["params"], v["batch_stats"], np.random.RandomState(5))
    return v


def variables_for(variables, K):
    """The weights at K frames a step: the K-wide decoder matrices re-drawn
    for K > 1, and the gate readout scaled up so that its energy moves by
    more than the threshold margin from step to step."""
    rng = np.random.RandomState(10 + K)
    params = dict(variables["params"])
    dec = dict(params["decoder"])
    dec["gate_w"] = dec["gate_w"] * 30.0
    params["decoder"] = dec
    if K == 1:
        return {"params": params, "batch_stats": variables["batch_stats"]}
    M = TINY.get("n_mel_channels", 80)
    P, RD = dec["prenet_w0"].shape[1], dec["proj_w"].shape[0]
    dec["prenet_w0"] = rng.uniform(-0.2, 0.2, (M * K, P)).astype(np.float32)
    dec["proj_w"] = rng.uniform(-0.2, 0.2, (RD, M * K)).astype(np.float32)
    dec["proj_b"] = rng.normal(0, 0.1, M * K).astype(np.float32)
    params["decoder"] = dec
    return {"params": params, "batch_stats": variables["batch_stats"]}


@pytest.fixture
def no_jax_dropout(monkeypatch):
    monkeypatch.setattr(jax_taco, "_dropout", lambda x, r, k: x)


def port_model(variables, hp):
    model = tacotron2_from_jax(variables["params"], variables["batch_stats"],
                               hp, device="cpu")
    model.decoder.prenet_dropout = False
    return model


def texts(hp, lengths, pad_to, seed=3):
    rng = np.random.RandomState(seed)
    ids = np.zeros((len(lengths), pad_to), np.int32)
    for b, L in enumerate(lengths):
        ids[b, :L] = rng.randint(1, hp.n_symbols, L)
    return ids


def pick_gate_threshold(energies, min_margin=1e-2):
    """Sigmoid threshold for step-level gate energies (B, S) at which every
    sample stops, at as many distinct steps as possible, with every energy
    up to its stop at least ``min_margin`` away from it."""
    best = None
    levels = np.unique(energies)
    for thr in np.concatenate([(levels[:-1] + levels[1:]) / 2,
                               levels - 2 * min_margin]):
        above = energies > thr
        if not above.any(axis=1).all():
            continue
        stops = above.argmax(axis=1)
        if stops.max() == energies.shape[1] - 1:
            continue  # a stop at the last step reads as no stop
        margin = min(np.abs(energies[b, :s + 1] - thr).min()
                     for b, s in enumerate(stops))
        if margin < min_margin:
            continue
        key = (len(set(stops.tolist())), stops.max())
        if best is None or key > best[0]:
            best = (key, thr)
    assert best is not None, "no gate threshold with a clean margin"
    return float(1.0 / (1.0 + np.exp(-best[1])))


def jax_infer(model, variables, ids, style, lengths, early_exit):
    out = model.apply(
        variables, jnp.asarray(ids), jnp.asarray(style), None, None, None,
        early_exit, method=model.infer,
        text_lengths=None if lengths is None else jnp.asarray(lengths),
        rngs={"dropout": jax.random.PRNGKey(7),
              "noise": jax.random.PRNGKey(8)})
    return [np.asarray(o) for o in out]


def port_infer(model, ids, style, lengths, early_exit):
    out = model.infer(
        torch.from_numpy(ids), torch.from_numpy(style),
        early_exit=early_exit,
        text_lengths=None if lengths is None else torch.from_numpy(lengths))
    return [o.numpy() for o in out]


CASES = [(q, K) for q in (False, True) for K in (1, 2)]


@pytest.mark.parametrize("quantized,K", CASES)
def test_encode_memory_matches_jax(jax_variables, quantized, K):
    jhp, hp = tiny_hparams(quantized_inference=quantized,
                           n_frames_per_step=K)
    variables = variables_for(jax_variables, K)
    lengths = np.array([9, 5, 7], np.int32)
    ids = texts(hp, lengths, 9)
    style = np.random.RandomState(1).rand(3, 1, hp.noise_size) \
        .astype(np.float32)
    model = jax_taco.Tacotron2(jhp)
    j_mem = model.apply(variables, jnp.asarray(ids), jnp.asarray(style),
                        text_lengths=jnp.asarray(lengths),
                        method=model.encode_memory,
                        rngs={"dropout": jax.random.PRNGKey(0)})[0]
    p_mem = port_model(variables, hp).encode_memory(
        torch.from_numpy(ids), torch.from_numpy(style),
        text_lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(p_mem.numpy(), np.asarray(j_mem),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("quantized,K", CASES)
def test_infer_matches_jax(jax_variables, no_jax_dropout, quantized, K):
    jhp, hp = tiny_hparams(quantized_inference=quantized,
                           n_frames_per_step=K)
    variables = variables_for(jax_variables, K)
    model = jax_taco.Tacotron2(jhp)
    port = port_model(variables, hp)
    rng = np.random.RandomState(2)
    cases = {"unpadded": (texts(hp, [8], 8), None),
             "padded": (texts(hp, [9, 5, 7], 9),
                        np.array([9, 5, 7], np.int32))}
    for name, (ids, lengths) in cases.items():
        style = rng.rand(ids.shape[0], 1, hp.noise_size).astype(np.float32)
        hp.gate_threshold = 1.0  # never stops: the gate energies alone
        energies = port_infer(port, ids, style, lengths, False)[2][:, ::K]
        hp.gate_threshold = jhp.gate_threshold = pick_gate_threshold(energies)
        for early_exit in (False, True):
            j = jax_infer(model, variables, ids, style, lengths, early_exit)
            p = port_infer(port, ids, style, lengths, early_exit)
            where = f"{name}, early_exit={early_exit}"
            for label, a, b in zip(("mel", "mel_postnet", "gate",
                                    "alignments"), p[:4], j[:4]):
                assert a.shape == b.shape, (label, where)
                np.testing.assert_allclose(a, b, atol=1e-4,
                                           err_msg=f"{label}, {where}")
            np.testing.assert_array_equal(p[4], j[4], err_msg=where)
            assert (p[4] < hp.max_decoder_steps * K).all(), where
        if name == "padded":
            assert len(set(p[4].tolist())) > 1, "stops at one step only"


def test_open_step_feeds_back_unzeroed_frame():
    """After a sample stops, its emitted frames are zero but the frame fed
    back to the prenet is the decoder's own output."""
    _, hp = tiny_hparams(gate_threshold=0.0)  # stops at step 1
    model = random_port_model(hp)
    dec = model.decoder
    memory = torch.randn(1, 5, model.memory_dim,
                         generator=torch.Generator().manual_seed(0))
    W = dec._scan_weights()
    carry = (dec._init_state(memory), memory.new_zeros(1, hp.n_mel_channels),
             torch.zeros(1, dtype=torch.bool), torch.full((1,), 9), 0)
    pm = memory @ dec.memory_w
    carry, (mel0, _, _) = dec._open_step(carry, None, memory, pm, W)
    assert carry[3].tolist() == [1] and carry[2].tolist() == [True]
    carry, (mel1, _, _) = dec._open_step(carry, None, memory, pm, W)
    assert mel1.abs().max() == 0 and carry[1].abs().max() > 0
    assert carry[3].tolist() == [1]


def random_port_model(hp):
    from gantron_tpu_torch.models.tacotron2 import Tacotron2

    model = Tacotron2(hp, device="cpu", seed=1)
    model.decoder.prenet_dropout = False
    return model
