"""Port parity of one G step and one D step from a JAX state in the two
conditioned configurations that put the labels in different places: labels
with noise on the memory side, and labels with noise on the encoder side
(``encoder_inputs``). Speakers in [0, 123) and emotions come from numpy, the
style the JAX G step draws is injected into the port's, and dropout is off
on both sides (tests/test_torch_train.py's setup).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gantron_tpu_torch.models.tacotron2 import N_SPEAKERS
from test_torch_conditioned import CONFIGS
from test_torch_train import (ATTN_W, D_LR, D_METRICS, G_LR, G_METRICS,
                              JaxRun, assert_states_match,
                              jax_dropout_off,  # noqa: F401
                              np_tree, rel_close)
from torch_threads import one_torch_thread  # noqa: F401


class ConditionedRun(JaxRun):
    """``JaxRun`` of test_torch_train with speakers in the batch and the
    style drawn on the side of the memory or of the encoder."""

    def __init__(self, **over):
        super().__init__(**over)
        B = self.batch.text.shape[0]
        self.batch = self.batch._replace(speaker=jnp.asarray(
            np.random.RandomState(6).randint(0, N_SPEAKERS, B), jnp.int32))

    def style(self, state, dtype=jnp.float32):
        k_noise = jax.random.split(state.rng, 7)[2]
        noise_rng = self.gen.apply({"params": state.g_params},
                                   rngs={"noise": k_noise},
                                   method=lambda m: m.make_rng("noise"))
        side = 0 if self.jhp.encoder_inputs else 1
        k = jax.random.split(noise_rng)[side]
        B = self.batch.text.shape[0]
        return np.array(jax.random.uniform(
            k, (B, 1, self.gen.noise_size), dtype=dtype), np.float32)


@pytest.fixture(scope="module")
def runs(jax_dropout_off):
    return {name: ConditionedRun(**CONFIGS[name])
            for name in ("labels_noise", "encoder_inputs")}


@pytest.mark.parametrize("config", ["labels_noise", "encoder_inputs"])
def test_g_and_d_step_match_jax(runs, config):
    """One G step (the style injected) then one D step from the same JAX
    state: metrics, every updated parameter of both models, the Adam
    moments and the BatchNorm running statistics, at test_torch_train.py's
    tolerances."""
    r = runs[config]
    p_state, (g_step, d_step, _) = r.port(r.state)
    batch = r.port_batch()
    j_state, j_m, (j_mel, j_len) = r.g_step(
        r.state, r.batch, jnp.float32(G_LR), jnp.float32(ATTN_W))
    p_state, p_m, (p_mel, p_len) = g_step(
        p_state, batch, G_LR, ATTN_W, style=torch.from_numpy(r.style(r.state)))
    for k in G_METRICS:
        rel_close(p_m[k], j_m[k], 1e-5, k)
    np.testing.assert_allclose(p_mel.numpy(), np.asarray(j_mel), atol=1e-4)
    j_state, j_dm = r.d_step(j_state, r.batch.mels, r.batch.output_lengths,
                             j_mel, j_len, jnp.float32(D_LR))
    p_state, p_dm = d_step(p_state, batch.mels, batch.output_lengths, p_mel,
                           p_len, D_LR)
    for k in D_METRICS:
        rel_close(p_dm[k], j_dm[k], 1e-5, k)
    assert_states_match(p_state, j_state, r.hp, config)
    assert np_tree(j_state.g_params)["speaker_embedding"].shape \
        == (N_SPEAKERS, 6)
