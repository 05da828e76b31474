"""A reader of the reference's torch checkpoints (port of
gantron_tpu/utils/torch_compat.py): a Brechard/GANtron ``state_dict`` as the
port's models, for serving and for warm starts.

The reference names (torch dotted paths) map onto the JAX package's
parameter trees, as the JAX package's reader maps them; those trees then go
through ``utils/jax_weights.py``'s loaders into the port's modules. The map:

  embedding.weight                         -> embedding
  speaker_embedding.weight                 -> speaker_embedding (VESUS)
  encoder.convolutions.i.0.conv.*          -> encoder/conv_i/conv
  encoder.convolutions.i.1.* (BatchNorm)   -> encoder/bn_i/bn (+ statistics)
  encoder.lstm.*_l0[_reverse]              -> encoder/lstm_fw | lstm_bw
  decoder.prenet.layers.i.linear_layer     -> decoder/prenet_wi
  decoder.attention_rnn.*                  -> decoder/attention_rnn
  decoder.attention_layer.query_layer.*    -> decoder/query_w       etc.
  decoder.decoder_rnn.*                    -> decoder/decoder_rnn
  decoder.linear_projection.linear_layer.* -> decoder/proj_w, proj_b
  decoder.gate_layer.linear_layer.*        -> decoder/gate_w, gate_b
  postnet.convolutions.i.0/1.*             -> postnet/conv_i, bn_i
  discriminator.i.module.0.* / .4.*        -> conv_i/conv, out (conv GAN D)
  discriminator.i.module.0.* / .3.*        -> dense_i, out (linear GAN D)

Layout rules: Linear (out, in) -> (in, out); Conv1d (out, in, k) ->
(k, in, out); LSTM weight_* (4H, D) -> (D, 4H) with b = b_ih + b_hh (the
gate order i, f, g, o is shared). The arithmetic is numpy's, as in the JAX
package's reader, so both give the same bits.
"""

import dataclasses
from typing import Dict, Tuple

import numpy as np

from gantron_tpu_torch.utils.jax_weights import (discriminator_from_jax,
                                                 tacotron2_from_jax)


def _lin(w):
    return np.ascontiguousarray(np.asarray(w).T)


def _conv(w):
    return np.ascontiguousarray(np.transpose(np.asarray(w), (2, 1, 0)))


def _lstm(sd, prefix, suffix=""):
    """(w_ih, w_hh, b) of ``prefix.weight_ih{suffix}`` and its peers."""
    return (_lin(sd[f"{prefix}.weight_ih{suffix}"]),
            _lin(sd[f"{prefix}.weight_hh{suffix}"]),
            sd[f"{prefix}.bias_ih{suffix}"] + sd[f"{prefix}.bias_hh{suffix}"])


def _conv_bn(sd, prefix):
    """(conv params, bn params, bn statistics) of a ``ConvNorm`` +
    ``BatchNorm1d`` pair named ``prefix.0`` and ``prefix.1``."""
    conv = {"conv": {"kernel": _conv(sd[f"{prefix}.0.conv.weight"]),
                     "bias": sd[f"{prefix}.0.conv.bias"]}}
    bn = {"bn": {"scale": sd[f"{prefix}.1.weight"],
                 "bias": sd[f"{prefix}.1.bias"]}}
    stats = {"bn": {"mean": sd[f"{prefix}.1.running_mean"],
                    "var": sd[f"{prefix}.1.running_var"]}}
    return conv, bn, stats


def _numpy(state_dict):
    return {k: (v.detach().cpu().numpy() if hasattr(v, "detach")
                else np.asarray(v)) for k, v in state_dict.items()}


def tacotron2_trees(state_dict, hp) -> Tuple[Dict, Dict]:
    """(params, batch_stats) in the JAX package's tree layout, numpy
    leaves, from a reference generator ``state_dict``."""
    sd = _numpy(state_dict)
    params: Dict = {"embedding": sd["embedding.weight"], "encoder": {},
                    "decoder": {}, "postnet": {}}
    stats: Dict = {"encoder": {}, "postnet": {}}
    if "speaker_embedding.weight" in sd:
        params["speaker_embedding"] = sd["speaker_embedding.weight"]
    for part, n in (("encoder", hp.encoder_n_convolutions),
                    ("postnet", hp.postnet_n_convolutions)):
        for i in range(n):
            conv, bn, st = _conv_bn(sd, f"{part}.convolutions.{i}")
            params[part][f"conv_{i}"], params[part][f"bn_{i}"] = conv, bn
            stats[part][f"bn_{i}"] = st
    params["encoder"]["lstm_fw"] = _lstm(sd, "encoder.lstm", "_l0")
    params["encoder"]["lstm_bw"] = _lstm(sd, "encoder.lstm", "_l0_reverse")

    d, att = params["decoder"], "decoder.attention_layer"
    d["prenet_w0"] = _lin(sd["decoder.prenet.layers.0.linear_layer.weight"])
    d["prenet_w1"] = _lin(sd["decoder.prenet.layers.1.linear_layer.weight"])
    d["attention_rnn"] = _lstm(sd, "decoder.attention_rnn")
    d["query_w"] = _lin(sd[f"{att}.query_layer.linear_layer.weight"])
    d["memory_w"] = _lin(sd[f"{att}.memory_layer.linear_layer.weight"])
    d["v_w"] = _lin(sd[f"{att}.v.linear_layer.weight"])
    d["loc_conv_w"] = _conv(
        sd[f"{att}.location_layer.location_conv.conv.weight"])
    d["loc_dense_w"] = _lin(
        sd[f"{att}.location_layer.location_dense.linear_layer.weight"])
    d["decoder_rnn"] = _lstm(sd, "decoder.decoder_rnn")
    d["proj_w"] = _lin(sd["decoder.linear_projection.linear_layer.weight"])
    d["proj_b"] = sd["decoder.linear_projection.linear_layer.bias"]
    d["gate_w"] = _lin(sd["decoder.gate_layer.linear_layer.weight"])
    d["gate_b"] = sd["decoder.gate_layer.linear_layer.bias"]
    return params, stats


def tacotron2_from_torch(state_dict, hp, device="cuda"):
    """The port's ``Tacotron2`` on ``device`` holding a reference generator
    ``state_dict`` (tensors or numpy arrays), BatchNorm running statistics
    included."""
    params, stats = tacotron2_trees(state_dict, hp)
    return tacotron2_from_jax(params, stats, hp, device)


def _with_type(hp, kind):
    return dataclasses.replace(hp, discriminator_type=kind)


def conv_discriminator_from_torch(state_dict, hp, device="cuda"):
    """The port's conv discriminator on ``device`` from the reference's
    (model.py:500-512): ``discriminator.{0..3}.module.0`` convs and
    ``discriminator.4``."""
    sd = _numpy(state_dict)
    params: Dict = {f"conv_{i}": {"conv": {
        "kernel": _conv(sd[f"discriminator.{i}.module.0.weight"]),
        "bias": sd[f"discriminator.{i}.module.0.bias"]}} for i in range(4)}
    params["out"] = {"kernel": _conv(sd["discriminator.4.weight"]),
                     "bias": sd["discriminator.4.bias"]}
    return discriminator_from_jax(params, _with_type(hp, "conv"), device)


def linear_discriminator_from_torch(state_dict, hp, device="cuda"):
    """The port's linear discriminator on ``device`` from the reference's
    (model.py:543-554): ``discriminator.{0,1,2}.module.0`` Linears and
    ``discriminator.3``."""
    sd = _numpy(state_dict)
    params: Dict = {f"dense_{i}": {
        "kernel": _lin(sd[f"discriminator.{i}.module.0.weight"]),
        "bias": sd[f"discriminator.{i}.module.0.bias"]} for i in range(3)}
    params["out"] = {"kernel": _lin(sd["discriminator.3.weight"]),
                     "bias": sd["discriminator.3.bias"]}
    return discriminator_from_jax(params, _with_type(hp, "linear"), device)


def load_reference_checkpoint(path, hp, device="cuda"):
    """The generator of a reference ``.ckpt`` (a ``torch.save``d dict whose
    ``"state_dict"`` holds it, reference train.py:158-166) as the port's
    ``Tacotron2`` on ``device``. The file is read with
    ``torch.load(..., weights_only=False)``: a reference checkpoint pickles
    more than tensors (its optimizers' states, the hparams), so it runs
    pickled code. Load only trusted files."""
    import torch

    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = {k: v.detach().float() for k, v in ckpt["state_dict"].items()}
    return tacotron2_from_torch(sd, hp, device)
