"""Port parity of the reference-checkpoint reader
(gantron_tpu_torch/utils/torch_compat.py) against the JAX package's
(gantron_tpu/utils/torch_compat.py) followed by the weight bridge
(utils/jax_weights.py): on synthetic state dicts in the reference's layout,
random numpy leaves under the names the JAX reader reads, every parameter and
BatchNorm statistic of the port's models must be bit-equal either way.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gantron_tpu.utils import torch_compat as jax_compat
from gantron_tpu_torch.models.discriminator import make_discriminator
from gantron_tpu_torch.models.tacotron2 import Tacotron2
from gantron_tpu_torch.utils import torch_compat
from gantron_tpu_torch.utils.jax_weights import (discriminator_from_jax,
                                                 tacotron2_from_jax)
from test_torch_tacotron2 import tiny_hparams
from torch_threads import one_torch_thread  # noqa: F401


def _draw(rng, shape):
    return rng.normal(0, 0.1, shape).astype(np.float32)


def reference_state_dict(hp, seed=0):
    """A Brechard/GANtron generator ``state_dict`` of ``hp``'s shapes, with
    random numpy leaves (running variances positive) and torch's
    ``num_batches_tracked`` beside each BatchNorm, which the readers skip.
    The shapes come from the port's model, in torch's layouts."""
    rng = np.random.RandomState(seed)
    m = Tacotron2(hp, device="cpu")
    d = m.decoder
    sd = {}

    def lin(name, w):      # port (in, out) -> torch Linear (out, in)
        sd[f"{name}.weight"] = _draw(rng, tuple(w.shape[::-1]))

    def lstm(name, p, suffix=""):
        for kind, w in (("ih", p.w_ih), ("hh", p.w_hh)):
            sd[f"{name}.weight_{kind}{suffix}"] = _draw(rng, w.shape[::-1])
            sd[f"{name}.bias_{kind}{suffix}"] = _draw(rng, p.b.shape)

    def convs(part, module):
        for i, (conv, bn) in enumerate(zip(module.convs, module.bns)):
            p = f"{part}.convolutions.{i}"
            sd[f"{p}.0.conv.weight"] = _draw(rng, conv.conv.weight.shape)
            sd[f"{p}.0.conv.bias"] = _draw(rng, conv.conv.bias.shape)
            n = bn.weight.shape[0]
            sd[f"{p}.1.weight"] = rng.uniform(0.8, 1.2, n).astype(np.float32)
            sd[f"{p}.1.bias"] = _draw(rng, n)
            sd[f"{p}.1.running_mean"] = _draw(rng, n)
            sd[f"{p}.1.running_var"] = rng.uniform(0.5, 1.5, n) \
                .astype(np.float32)
            sd[f"{p}.1.num_batches_tracked"] = np.array(7, np.int64)

    sd["embedding.weight"] = _draw(rng, m.embedding.shape)
    if hp.vesus_path:
        sd["speaker_embedding.weight"] = _draw(rng,
                                               m.speaker_embedding.shape)
    convs("encoder", m.encoder)
    lstm("encoder.lstm", m.encoder.lstm_fw, "_l0")
    lstm("encoder.lstm", m.encoder.lstm_bw, "_l0_reverse")
    lin("decoder.prenet.layers.0.linear_layer", d.prenet_w0)
    lin("decoder.prenet.layers.1.linear_layer", d.prenet_w1)
    lstm("decoder.attention_rnn", d.attention_rnn)
    att = "decoder.attention_layer"
    lin(f"{att}.query_layer.linear_layer", d.query_w)
    lin(f"{att}.memory_layer.linear_layer", d.memory_w)
    lin(f"{att}.v.linear_layer", d.v_w)
    k, c, f = d.loc_conv_w.shape  # the port's (k, 2, filters)
    sd[f"{att}.location_layer.location_conv.conv.weight"] = _draw(
        rng, (f, c, k))
    lin(f"{att}.location_layer.location_dense.linear_layer", d.loc_dense_w)
    lstm("decoder.decoder_rnn", d.decoder_rnn)
    lin("decoder.linear_projection.linear_layer", d.proj_w)
    sd["decoder.linear_projection.linear_layer.bias"] = _draw(
        rng, d.proj_b.shape)
    lin("decoder.gate_layer.linear_layer", d.gate_w)
    sd["decoder.gate_layer.linear_layer.bias"] = _draw(rng, d.gate_b.shape)
    convs("postnet", m.postnet)
    return sd


def assert_bit_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert list(sa) == list(sb)
    for name in sa:
        assert torch.equal(sa[name], sb[name]), name


@pytest.mark.parametrize("conditioned", [False, True])
def test_tacotron2_reader_is_jax_reader_then_bridge(conditioned):
    over = (dict(vesus_path="vesus", speakers_embedding=6, use_labels=True)
            if conditioned else {})
    jhp, hp = tiny_hparams(**over)
    sd = reference_state_dict(hp, seed=int(conditioned))
    assert ("speaker_embedding.weight" in sd) == conditioned
    params, stats = jax_compat.tacotron2_from_torch(sd, jhp)
    ref = tacotron2_from_jax(params, stats, hp, device="cpu")
    ours = torch_compat.tacotron2_from_torch(sd, hp, device="cpu")
    assert_bit_equal(ours, ref)
    # Spot checks of the layout rules against the dict itself.
    d = ours.decoder
    np.testing.assert_array_equal(
        d.query_w.detach().numpy(),
        sd["decoder.attention_layer.query_layer.linear_layer.weight"].T)
    np.testing.assert_array_equal(
        d.decoder_rnn.b.detach().numpy(),
        sd["decoder.decoder_rnn.bias_ih"] + sd["decoder.decoder_rnn.bias_hh"])
    np.testing.assert_array_equal(
        ours.postnet.bns[1].running_var.numpy(),
        sd["postnet.convolutions.1.1.running_var"])


@pytest.mark.parametrize("kind", ["conv", "linear"])
def test_discriminator_readers_are_jax_readers_then_bridge(kind):
    _, hp = tiny_hparams(discriminator_dim=32)
    hp = dataclasses.replace(hp, discriminator_type=kind)
    rng = np.random.RandomState(2)
    model = make_discriminator(hp, device="cpu")
    sd = {}
    if kind == "conv":
        for i, conv in enumerate(model.convs):
            sd[f"discriminator.{i}.module.0.weight"] = _draw(
                rng, conv.conv.weight.shape)
            sd[f"discriminator.{i}.module.0.bias"] = _draw(
                rng, conv.conv.bias.shape)
        sd["discriminator.4.weight"] = _draw(rng, model.out.weight.shape)
        sd["discriminator.4.bias"] = _draw(rng, model.out.bias.shape)
        params = jax_compat.conv_discriminator_from_torch(sd, hp)
        ours = torch_compat.conv_discriminator_from_torch(sd, hp, "cpu")
    else:
        for i, layer in enumerate(model.dense):
            sd[f"discriminator.{i}.module.0.weight"] = _draw(
                rng, layer.w.shape[::-1])
            sd[f"discriminator.{i}.module.0.bias"] = _draw(rng,
                                                           layer.b.shape)
        sd["discriminator.3.weight"] = _draw(rng, model.out.w.shape[::-1])
        sd["discriminator.3.bias"] = _draw(rng, model.out.b.shape)
        params = jax_compat.linear_discriminator_from_torch(sd, hp)
        ours = torch_compat.linear_discriminator_from_torch(sd, hp, "cpu")
    assert_bit_equal(ours, discriminator_from_jax(params, hp, "cpu"))


def test_load_reference_checkpoint(tmp_path):
    """A ``torch.save``d ``{"state_dict": ...}`` with tensors (and what a
    reference checkpoint pickles beside them) reads into the same model."""
    jhp, hp = tiny_hparams(vesus_path="vesus", speakers_embedding=6)
    sd = reference_state_dict(hp, seed=3)
    path = tmp_path / "reference.ckpt"
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()},
                "iteration": 12, "learning_rate": 1e-3,
                "hparams": {"use_noise": True}}, path)
    ours = torch_compat.load_reference_checkpoint(path, hp, device="cpu")
    params, stats = jax_compat.load_reference_checkpoint(path, jhp)
    assert_bit_equal(ours, tacotron2_from_jax(params, stats, hp, "cpu"))
    assert_bit_equal(ours, torch_compat.tacotron2_from_torch(sd, hp, "cpu"))
