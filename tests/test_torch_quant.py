"""Port parity: int8 weight streaming (gantron_tpu_torch/ops/quant.py) against
the JAX package's ``quantize_per_channel``, ``qmatmul`` and the Pallas kernel
``qmatmul_pallas`` run in interpret mode.

On the CPU the ``qmm`` wrapper computes the plain version and never launches
its CUDA kernel; the kernel itself is held against the plain version on the
card by ``chip_smoke.py``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from gantron_tpu.ops import quant as jq
from gantron_tpu_torch.ops import quant as pq
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _weights(I, O, seed=0):
    rng = np.random.RandomState(seed)
    w = rng.normal(0, 0.05, (I, O)).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero column takes scale 1
    w[5, 7] = 0.4  # an outlier sets its column's scale
    return w


def test_quantize_per_channel_bit_equal():
    w = _weights(96, 256)
    jm = jq.quantize_per_channel(jnp.asarray(w))
    pm = pq.quantize_per_channel(torch.from_numpy(w))
    assert pm.q.dtype == torch.int8 and pm.scale.dtype == torch.float32
    np.testing.assert_array_equal(pm.q.numpy(), np.asarray(jm.q))
    np.testing.assert_array_equal(pm.scale.numpy(), np.asarray(jm.scale))
    np.testing.assert_array_equal(
        pq.dequantize(pm).numpy(), np.asarray(jq.dequantize(jm)))


@pytest.mark.parametrize("B", [1, 3, 8])
def test_qmatmul_matches_jax_and_pallas(B):
    I, O = 64, 256
    w = _weights(I, O, seed=B)
    x = np.random.RandomState(10 + B).normal(0, 1, (B, I)).astype(np.float32)
    jm = jq.quantize_per_channel(jnp.asarray(w))
    pm = pq.quantize_per_channel(torch.from_numpy(w))
    y = pq.qmatmul(torch.from_numpy(x), pm).numpy()
    y_xla = np.asarray(jq.qmatmul(jnp.asarray(x), jm))
    y_pallas = np.asarray(jq.qmatmul_pallas(jnp.asarray(x), jm, block_o=128,
                                            interpret=True))
    np.testing.assert_allclose(y, y_xla, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y, y_pallas, rtol=1e-5, atol=1e-5)


def test_qmm_on_cpu_is_the_plain_version_and_launches_nothing():
    w = _weights(48, 40)  # ragged: O is no multiple of a tile
    x = torch.from_numpy(
        np.random.RandomState(1).normal(0, 1, (3, 48)).astype(np.float32))
    pm = pq.quantize_per_channel(torch.from_numpy(w))
    before = pq.qmm.launches
    np.testing.assert_array_equal(pq.qmm(x, pm).numpy(),
                                  pq.qmatmul(x, pm).numpy())
    np.testing.assert_array_equal(pq.matmul_rhs(x, pm).numpy(),
                                  pq.qmatmul(x, pm).numpy())
    np.testing.assert_array_equal(pq.matmul_rhs(x, torch.from_numpy(w)),
                                  x @ torch.from_numpy(w))
    assert pq.qmm.launches == before == 0


def test_qmm_bf16_plain_version_on_cpu():
    w = _weights(64, 32)
    x = torch.from_numpy(
        np.random.RandomState(2).normal(0, 1, (2, 64)).astype(np.float32))
    pm = pq.quantize_per_channel(torch.from_numpy(w))
    y = pq.qmm(x.bfloat16(), pm)
    assert y.dtype == torch.bfloat16
    ref = (x.bfloat16().float() @ pm.q.float()) * pm.scale
    np.testing.assert_allclose(y.float().numpy(), ref.numpy(), rtol=1e-2,
                               atol=1e-2)


def test_qmm_refuses_other_devices():
    pm = pq.quantize_per_channel(torch.ones(4, 4))
    with pytest.raises(ValueError):
        pq.qmm(torch.ones(1, 4, device="meta"), pm)


def test_quant_imports_without_triton_or_nvcc():
    """Importing the port (and the wrapper's CPU path) needs neither triton
    nor nvcc: nothing is built or imported until a CUDA tensor arrives."""
    code = (
        "import sys; sys.modules['triton'] = None\n"
        "import torch\n"
        "from gantron_tpu_torch.ops import quant\n"
        "pm = quant.quantize_per_channel(torch.ones(8, 4))\n"
        "quant.qmm(torch.ones(2, 8), pm)\n"
        "from gantron_tpu_torch.utils import cuda_build\n"
        "assert quant.qmm.launches == 0 and not cuda_build._libs\n")
    env = dict(os.environ, PATH="/nonexistent", CUDA_HOME="/nonexistent",
               PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=REPO)
