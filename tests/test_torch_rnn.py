"""Port parity: the LSTM primitives (gantron_tpu_torch/ops/rnn.py) against the
JAX package's, on numpy-seeded weights and ragged lengths."""

import numpy as np

import jax.numpy as jnp
import torch

from gantron_tpu.ops import rnn as jr
from gantron_tpu_torch.ops import rnn as pr
from torch_threads import one_torch_thread  # noqa: F401


def _params(rng, D, H):
    u = lambda *s: rng.uniform(-0.3, 0.3, s).astype(np.float32)  # noqa: E731
    return u(D, 4 * H), u(H, 4 * H), u(4 * H)


def _port(params):
    p = pr.LSTMParams(params[0].shape[0], params[1].shape[0])
    for name, value in zip(("w_ih", "w_hh", "b"), params):
        getattr(p, name).data.copy_(torch.from_numpy(value))
    return p


def test_lstm_cell_matches_jax():
    rng = np.random.RandomState(0)
    params = _params(rng, 6, 5)
    x, h, c = (rng.normal(0, 1, (3, n)).astype(np.float32) for n in (6, 5, 5))
    jh, jc = jr.lstm_cell(jr.LSTMParams(*map(jnp.asarray, params)),
                          jnp.asarray(x), jnp.asarray(h), jnp.asarray(c))
    with torch.no_grad():
        ph, pc = pr.lstm_cell(_port(params), *map(torch.from_numpy, (x, h, c)))
    np.testing.assert_allclose(ph.numpy(), np.asarray(jh), atol=1e-6)
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), atol=1e-6)


def test_masked_bilstm_matches_jax_on_ragged_lengths():
    rng = np.random.RandomState(1)
    B, T, D, H = 4, 9, 7, 6
    fw, bw = _params(rng, D, H), _params(rng, D, H)
    xs = rng.normal(0, 1, (B, T, D)).astype(np.float32)
    lengths = np.array([9, 4, 1, 6], np.int32)
    ref = jr.masked_bilstm(jr.LSTMParams(*map(jnp.asarray, fw)),
                           jr.LSTMParams(*map(jnp.asarray, bw)),
                           jnp.asarray(xs), jnp.asarray(lengths))
    with torch.no_grad():
        out = pr.masked_bilstm(_port(fw), _port(bw), torch.from_numpy(xs),
                               torch.from_numpy(lengths).long())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    # Zero beyond each length, as pad_packed_sequence gives.
    for b in np.flatnonzero(lengths < T):
        assert out[b, lengths[b]:].abs().max() == 0
