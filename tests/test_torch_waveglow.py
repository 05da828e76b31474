"""Port parity: WaveGlow inference (gantron_tpu_torch/models/waveglow.py)
against the JAX package's, on a small configuration with the same weights
(carried over by utils/jax_weights.py) and the same injected latents z."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gantron_tpu.models import waveglow as jw
from gantron_tpu_torch.models import waveglow as pw
from gantron_tpu_torch.utils.jax_weights import waveglow_from_jax
from torch_threads import one_torch_thread  # noqa: F401


def small_cfg(cls, **over):
    kw = dict(n_mel_channels=8, n_flows=4, n_group=4, n_early_every=2,
              n_early_size=1, n_layers=2, n_channels=32, kernel_size=3,
              upsample_kernel=16, upsample_stride=8)
    kw.update(over)
    return cls(**kw)


def _jax_params(cfg):
    """The JAX package's random params with the end layers made non-zero,
    so that every coupling layer acts."""
    params = jax.tree_util.tree_map(
        np.asarray, jw.random_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.RandomState(1)
    for wn in params["wn"]:
        wn["end_w"] = rng.normal(0, 0.05, wn["end_w"].shape) \
            .astype(np.float32)
        wn["end_b"] = rng.normal(0, 0.05, wn["end_b"].shape) \
            .astype(np.float32)
    return params


@pytest.mark.parametrize("kernel,stride", [(16, 8), (12, 8)])
def test_infer_matches_jax_with_injected_z(kernel, stride):
    """(16, 8): the stride divides the upsampler's kernel (its fast path);
    (12, 8): it does not."""
    jcfg = small_cfg(jw.WaveGlowConfig, upsample_kernel=kernel,
                     upsample_stride=stride)
    pcfg = small_cfg(pw.WaveGlowConfig, upsample_kernel=kernel,
                     upsample_stride=stride)
    params = _jax_params(jcfg)
    j_wg = jw.WaveGlow(jcfg, jax.tree_util.tree_map(jnp.asarray, params))
    p_wg = waveglow_from_jax(params, pcfg, device="cpu")

    B, T = 2, 7
    rng = np.random.RandomState(2)
    mel = rng.normal(-4, 1, (B, jcfg.n_mel_channels, T)).astype(np.float32)
    assert p_wg.z_shapes(T) == j_wg.z_shapes(T)
    z = [rng.normal(0, 1, (B,) + s).astype(np.float32)
         for s in j_wg.z_shapes(T)]
    ref = np.asarray(j_wg.infer(jnp.asarray(mel), 0.666,
                                z=[jnp.asarray(zi) for zi in z]))
    out = p_wg.infer(torch.from_numpy(mel), 0.666,
                     z=[torch.from_numpy(zi) for zi in z]).numpy()
    assert out.shape == ref.shape == (B, T * stride)
    np.testing.assert_allclose(out, ref, atol=1e-4)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


def test_random_params_shapes_match_jax():
    """The port's random WaveGlow has the JAX one's shapes, in torch's conv
    layout, and orthogonal 1x1 convs."""
    pcfg = small_cfg(pw.WaveGlowConfig)
    jcfg = small_cfg(jw.WaveGlowConfig)
    ref = waveglow_from_jax(_jax_params(jcfg), pcfg, device="cpu").params
    p_wg = pw.WaveGlow(pcfg, pw.random_params(
        torch.Generator().manual_seed(0), pcfg), device="cpu")
    ours = p_wg.params
    assert _shapes(ours) == _shapes(ref)
    for w in ours["convinv_inv"]:
        np.testing.assert_allclose((w @ w.T).numpy(), np.eye(w.shape[0]),
                                   atol=1e-5)
    audio = p_wg.infer(torch.zeros(1, 8, 5),
                       generator=torch.Generator().manual_seed(3))
    assert audio.shape == (1, 5 * pcfg.upsample_stride)
    assert torch.isfinite(audio).all()


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    cfg = small_cfg(pw.WaveGlowConfig)
    with pytest.raises(RuntimeError, match="CUDA"):
        pw.WaveGlow(cfg, pw.random_params(torch.Generator(), cfg))


def test_forward_matches_jax():
    """The training direction (audio -> latents) on the same weights: every
    latent within 1e-4 of JAX's, in ``z_shapes``' order and layout."""
    jcfg, pcfg = small_cfg(jw.WaveGlowConfig), small_cfg(pw.WaveGlowConfig)
    params = _jax_params(jcfg)
    j_wg = jw.WaveGlow(jcfg, jax.tree_util.tree_map(jnp.asarray, params))
    p_wg = waveglow_from_jax(params, pcfg, device="cpu")
    B, T = 2, 9
    rng = np.random.RandomState(3)
    mel = rng.normal(-4, 1, (B, jcfg.n_mel_channels, T)).astype(np.float32)
    audio = (rng.randn(B, j_wg.n_groups(T) * jcfg.n_group) * 0.3) \
        .astype(np.float32)
    ref = j_wg.forward(jnp.asarray(audio), jnp.asarray(mel))
    out = p_wg.forward(torch.from_numpy(audio), torch.from_numpy(mel))
    assert [tuple(z.shape[1:]) for z in out] == p_wg.z_shapes(T)
    for z, zr in zip(out, ref):
        np.testing.assert_allclose(z.numpy(), np.asarray(zr), atol=1e-4)


def test_forward_then_infer_gives_the_audio_back():
    """infer(mel, sigma=1.0, z=forward(audio, mel)) == audio (atol 2e-4, as
    tests/test_waveglow.py), with random non-zero coupling layers."""
    cfg = small_cfg(pw.WaveGlowConfig)
    wg = waveglow_from_jax(_jax_params(small_cfg(jw.WaveGlowConfig)), cfg,
                           device="cpu")
    rng = np.random.RandomState(1)
    mel = torch.from_numpy(rng.randn(2, 8, 12).astype(np.float32))
    audio = torch.from_numpy(
        (rng.randn(2, wg.n_groups(12) * cfg.n_group) * 0.3)
        .astype(np.float32))
    rec = wg.infer(mel, sigma=1.0, z=wg.forward(audio, mel))
    np.testing.assert_allclose(rec.numpy(), audio.numpy(), atol=2e-4)


def test_bfloat16_infer_is_finite_and_near_float32():
    """``dtype=torch.bfloat16`` (rtf.py's flow): float32 audio, finite, and
    within 5e-2 of the float32 flow's on the same weights (non-zero
    coupling layers) and latents: bfloat16 keeps 8 bits of mantissa
    through 4 flows."""
    cfg = small_cfg(pw.WaveGlowConfig)
    f32 = waveglow_from_jax(_jax_params(small_cfg(jw.WaveGlowConfig)), cfg,
                            device="cpu")
    bf16 = pw.WaveGlow(cfg, f32.params, device="cpu", dtype=torch.bfloat16)
    assert all(w.dtype == torch.bfloat16 for w in bf16.params["convinv_inv"])
    rng = np.random.RandomState(5)
    mel = torch.from_numpy(rng.normal(-4, 1, (2, 8, 10)).astype(np.float32))
    z = [torch.from_numpy(rng.randn(2, *s).astype(np.float32))
         for s in f32.z_shapes(10)]
    a, b = f32.infer(mel, z=z), bf16.infer(mel, z=z)
    assert b.dtype == torch.float32 and torch.isfinite(b).all()
    np.testing.assert_allclose(b.numpy(), a.numpy(), atol=5e-2)
    assert (b - a).abs().max() > 0
