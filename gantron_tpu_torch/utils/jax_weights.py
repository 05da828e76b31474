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

This is the inverse of the naming map of ``gantron_tpu/utils/torch_compat.py``.
"""

import numpy as np
import torch

from gantron_tpu_torch.models.tacotron2 import Tacotron2
from gantron_tpu_torch.models.waveglow import WaveGlow
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
    (``variables["params"]``, ``variables["batch_stats"]``)."""
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
    return model.to(device)


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
