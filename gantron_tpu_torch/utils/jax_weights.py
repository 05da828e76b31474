"""Weights carried over from the JAX package's parameter trees.

The inputs are the JAX package's trees with numpy (or any array-like) leaves,
for example ``jax.tree.map(np.asarray, variables)``; this module itself needs
neither JAX nor flax. Layout rules, from the JAX side to the port:

  * conv kernel (k, in, out)      -> nn.Conv1d weight (out, in, k)
  * dense kernel (in, out)        -> kept: the port multiplies x @ W as well
  * LSTM (w_ih (D, 4H), w_hh (H, 4H), b (4H,)) with the summed bias -> kept
  * flax BatchNorm scale/bias + batch_stats mean/var -> weight, bias,
    running_mean, running_var
  * WaveGlow conv kernels (k, in, out) -> (out, in, k); the upsampler's
    (k, Cout, Cin) -> ConvTranspose1d's (Cin, Cout, k)
  * discriminator dense kernels (in, out) -> kept
  * classifier conv kernels (kh, kw, in, out) -> nn.Conv2d-style
    (out, in, kh, kw); its head keeps its rows, since the port flattens in
    the JAX package's (H, W, C) order

This is the inverse of the naming map of ``gantron_tpu/utils/torch_compat.py``.
A training state carries over too (``train_state_from_jax``): the Adam
moments of a parameter take the parameter's layout rule, so they are read
through the same loaders.
"""

import numpy as np
import torch

from gantron_tpu_torch.models.classifier import Classifier
from gantron_tpu_torch.models.discriminator import make_discriminator
from gantron_tpu_torch.models.tacotron2 import Tacotron2
from gantron_tpu_torch.models.waveglow import WaveGlow
from gantron_tpu_torch.train.state import AdamState, wrap_models
from gantron_tpu_torch.utils.device import resolve_device


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(k):
    """(k, in, out) -> (out, in, k)."""
    return _t(np.transpose(np.asarray(k), (2, 1, 0)))


def _set(param, value):
    if tuple(param.shape) != tuple(value.shape):
        raise ValueError(f"shape mismatch: port {tuple(param.shape)} vs "
                         f"JAX {tuple(value.shape)}")
    param.data.copy_(value)


def _load_convs(convs, bns, params, stats):
    for i, (conv, bn) in enumerate(zip(convs, bns)):
        c = params[f"conv_{i}"]["conv"]
        _set(conv.conv.weight, _conv(c["kernel"]))
        _set(conv.conv.bias, _t(c["bias"]))
        b, s = params[f"bn_{i}"]["bn"], stats[f"bn_{i}"]["bn"]
        _set(bn.weight, _t(b["scale"]))
        _set(bn.bias, _t(b["bias"]))
        _set(bn.running_mean, _t(s["mean"]))
        _set(bn.running_var, _t(s["var"]))


def _load_lstm(lstm, tree):
    w_ih, w_hh, b = tree[0], tree[1], tree[2]
    _set(lstm.w_ih, _t(w_ih))
    _set(lstm.w_hh, _t(w_hh))
    _set(lstm.b, _t(b))


def tacotron2_from_jax(params, batch_stats, hp, device="cuda") -> Tacotron2:
    """A port ``Tacotron2`` on ``device`` holding the JAX model's weights
    (``variables["params"]``, the InfoGAN style encoder's too when ``hp``
    has one) and BatchNorm running statistics (``variables["batch_stats"]``,
    which training updates)."""
    device = resolve_device(device)
    model = Tacotron2(hp, device="cpu")
    _set(model.embedding, _t(params["embedding"]))
    if hp.vesus_path:
        _set(model.speaker_embedding, _t(params["speaker_embedding"]))
    enc, post = params["encoder"], params["postnet"]
    _load_convs(model.encoder.convs, model.encoder.bns, enc,
                batch_stats["encoder"])
    _load_lstm(model.encoder.lstm_fw, enc["lstm_fw"])
    _load_lstm(model.encoder.lstm_bw, enc["lstm_bw"])
    _load_convs(model.postnet.convs, model.postnet.bns, post,
                batch_stats["postnet"])
    dec, d = params["decoder"], model.decoder
    for name in ("prenet_w0", "prenet_w1", "query_w", "memory_w", "v_w",
                 "loc_conv_w", "loc_dense_w", "proj_w", "proj_b", "gate_w",
                 "gate_b"):
        _set(getattr(d, name), _t(dec[name]))
    _load_lstm(d.attention_rnn, dec["attention_rnn"])
    _load_lstm(d.decoder_rnn, dec["decoder_rnn"])
    if model.style_reconstruction:
        se, tree = model.style_encoder, params["style_encoder"]
        for name in ("conv_0", "conv_1"):
            _set(getattr(se, name).weight, _conv(tree[name]["kernel"]))
            _set(getattr(se, name).bias, _t(tree[name]["bias"]))
        _set(se.out_w, _t(tree["out"]["kernel"]))
        _set(se.out_b, _t(tree["out"]["bias"]))
    return model.to(device)


def discriminator_from_jax(params, hp, device="cuda"):
    """A port discriminator of ``hp.discriminator_type`` on ``device`` holding
    the JAX discriminator's params."""
    device = resolve_device(device)
    model = make_discriminator(hp, device="cpu")
    if hp.discriminator_type == "linear":
        for layer, name in zip(list(model.dense) + [model.out],
                               ["dense_0", "dense_1", "dense_2", "out"]):
            _set(layer.w, _t(params[name]["kernel"]))
            _set(layer.b, _t(params[name]["bias"]))
    else:
        for i, conv in enumerate(model.convs):
            c = params[f"conv_{i}"]["conv"]
            _set(conv.conv.weight, _conv(c["kernel"]))
            _set(conv.conv.bias, _t(c["bias"]))
        _set(model.out.weight, _conv(params["out"]["kernel"]))
        _set(model.out.bias, _t(params["out"]["bias"]))
    return model.to(device)


def classifier_from_jax(variables, hp, device="cuda") -> Classifier:
    """A port ``Classifier`` of ``hp`` on ``device`` holding the JAX
    classifier's ``params`` and BatchNorm ``batch_stats``."""
    device = resolve_device(device)
    model = Classifier(hp)
    params, stats = variables["params"], variables.get("batch_stats", {})
    prefix = "dense" if model.linear else "conv"
    for i, (layer, bn) in enumerate(zip(model.layers, model.bns)):
        p = params[f"{prefix}_{i}"]
        if model.linear:
            _set(layer.w, _t(p["kernel"]))
        else:
            _set(layer.weight, _t(np.transpose(np.asarray(p["kernel"]),
                                               (3, 2, 0, 1))))
        _set(layer.b if model.linear else layer.bias, _t(p["bias"]))
        b, s = params[f"bn_{i}"], stats[f"bn_{i}"]
        _set(bn.weight, _t(b["scale"]))
        _set(bn.bias, _t(b["bias"]))
        _set(bn.running_mean, _t(s["mean"]))
        _set(bn.running_var, _t(s["var"]))
    _set(model.head.w, _t(params["head"]["kernel"]))
    _set(model.head.b, _t(params["head"]["bias"]))
    return model.to(device)


def _adam_state(opt_state, to_model):
    """The Adam moments of an optax chain's state, as port tensors in the
    order of the port model's parameters (``to_model`` builds a port model
    from a params-shaped tree)."""
    adam = next(s for s in opt_state if hasattr(s, "mu"))
    mu, nu = (list(to_model(tree).parameters()) for tree in (adam.mu, adam.nu))
    return AdamState(int(np.asarray(adam.count)), [m.detach() for m in mu],
                     [v.detach() for v in nu])


def train_state_from_jax(state, hp, device="cuda", seed: int = 0):
    """A port ``GANTrainState`` on ``device`` from the JAX package's
    ``GANTrainState`` with numpy leaves: both models, the BatchNorm running
    statistics, both Adam states (moments and count) and the step count.
    The port's dropout and noise generators come from ``seed`` (JAX's key
    has no torch counterpart). Returns (state, g_model, d_model, g_tx,
    d_tx), as ``create_train_state``."""
    def g_from(tree):
        return tacotron2_from_jax(tree, state.g_batch_stats, hp, device)

    def d_from(tree):
        return discriminator_from_jax(tree, hp, device)

    return wrap_models(hp, g_from(state.g_params), d_from(state.d_params),
                       seed, _adam_state(state.g_opt_state, g_from),
                       _adam_state(state.d_opt_state, d_from),
                       int(np.asarray(state.step)))


def waveglow_from_jax(params, cfg, device="cuda") -> WaveGlow:
    """A port ``WaveGlow`` on ``device`` from the JAX WaveGlow's params."""
    out = {"upsample_w": _conv(params["upsample_w"]),
           "upsample_b": _t(params["upsample_b"]),
           "convinv_inv": [_t(w) for w in params["convinv_inv"]], "wn": []}

    def leaf(name, v):
        return _conv(v) if name.endswith("_w") else _t(v)

    for wn in params["wn"]:
        out["wn"].append({
            name: ([leaf(name, x) for x in v] if isinstance(v, (list, tuple))
                   else leaf(name, v))
            for name, v in wn.items()})
    return WaveGlow(cfg, out, device=device)
