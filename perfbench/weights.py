"""Random weights made on the device from the seed, in a few large draws.

Each network's tensors are slices of one uniform draw on the device
(``torch.rand`` with a ``torch.Generator`` there), each scaled to the
spread of its published initialization (Xavier-uniform with the layer's
gain, LSTM's 1/sqrt(H), BatchNorm near identity with running statistics
spread around it), so that activations stay in range through the
decoder's 500 steps and WaveGlow's 12 flows. WaveGlow's weights are
N(0, 0.02^2), its end layers too (nonzero, so every coupling reads the
mel), its 1x1 convs orthogonal; they are served in bfloat16. The
benchmark hands the same tensors to the program and to the reference.
"""

import math

import torch

from perfbench.reference import discriminator as ref_d
from perfbench.reference import tacotron2 as ref_taco
from perfbench.reference import waveglow as ref_wg

_GAIN = {"linear": 1.0, "tanh": 5.0 / 3.0, "relu": math.sqrt(2.0)}


def _xavier(shape, gain):
    if len(shape) == 2:
        fan_in, fan_out = shape
    else:  # (out, in, k)
        fan_in, fan_out = shape[1] * shape[2], shape[0] * shape[2]
    return _GAIN[gain] * math.sqrt(6.0 / (fan_in + fan_out))


def _taco_spread(name, shape, m):
    """(scale, offset) of U(-1, 1) for one generator tensor."""
    if name in ("embedding", "speaker_embedding"):
        n = m["n_symbols"] + m["symbols_embedding_dim"]
        return math.sqrt(3.0) * math.sqrt(2.0 / n), 0.0
    if ".bns." in name:
        return {"weight": (0.1, 1.0), "bias": (0.1, 0.0),
                "running_mean": (0.1, 0.0),
                "running_var": (0.5, 1.0)}[name.rsplit(".", 1)[1]]
    if name.endswith("conv.bias"):
        return 1.0 / math.sqrt(shape[0] * 5), 0.0
    if name.endswith("conv.weight"):
        if name.startswith("encoder"):
            return _xavier(shape, "relu"), 0.0
        last = f"postnet.convs.{m['postnet_n_convolutions'] - 1}."
        return _xavier(shape, "linear" if name.startswith(last)
                       else "tanh"), 0.0
    if ".lstm_" in name or "_rnn." in name:
        H = shape[-1] // 4
        return (2.0 if name.endswith(".b") else 1.0) / math.sqrt(H), 0.0
    if name == "decoder.loc_conv_w":
        k, c, f = shape
        return math.sqrt(6.0 / (c * k + f * k)), 0.0
    if name in ("decoder.proj_b", "decoder.gate_b"):
        return 0.1, 0.0
    gain = "tanh" if name in ("decoder.query_w", "decoder.memory_w",
                              "decoder.loc_dense_w") else "linear"
    return _xavier(shape, gain), 0.0


def _draw(shapes, spreads, generator, device):
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.rand(total, generator=generator, device=device) * 2 - 1
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        scale, offset = spreads(name, shape)
        out[name] = (flat[at:at + n].view(shape) * scale + offset).contiguous()
        at += n
    return out


def tacotron2(m, generator, device, gate_bias=None) -> dict:
    """The generator's tensors (``reference.tacotron2.param_shapes``), float32.
    ``gate_bias``: the gate readout's bias, set (serving holds the gate
    off with -20, so every request decodes its own frames)."""
    W = _draw(ref_taco.param_shapes(m), lambda n, s: _taco_spread(n, s, m),
              generator, device)
    if gate_bias is not None:
        W["decoder.gate_b"].fill_(gate_bias)
    return W


def discriminator(m, generator, device) -> dict:
    def spread(name, shape):
        if name == "out.weight":
            return math.sqrt(3.0 / shape[1]), 0.0
        if name.endswith("bias"):
            return 0.1, 0.0
        return _xavier(shape, "tanh"), 0.0

    return _draw(ref_d.param_shapes(m), spread, generator, device)


def waveglow(wc, generator, device, n_mel=80, dtype=torch.bfloat16) -> dict:
    """WaveGlow's params in the program's layout (``models/waveglow.py``):
    the upsampler, and per flow its inverse 1x1 conv and WaveNet dict.
    ``wc``: the configuration's ``waveglow`` dict."""
    n, L, k = wc["n_channels"], wc["n_layers"], wc["kernel_size"]
    D = n_mel * wc["n_group"]
    shapes = {"upsample_w": (n_mel, n_mel, wc["upsample_kernel"]),
              "upsample_b": (n_mel,)}
    for f in range(wc["n_flows"]):
        c = ref_wg.channels(wc, f)
        h = c // 2
        shapes.update({
            f"{f}.q": (c, c), f"{f}.start_w": (n, h, 1), f"{f}.start_b": (n,),
            f"{f}.end_w": (2 * h, n, 1), f"{f}.end_b": (2 * h,),
            f"{f}.cond_w": (2 * n * L, D, 1), f"{f}.cond_b": (2 * n * L,)})
        for i in range(L):
            o = 2 * n if i < L - 1 else n
            shapes.update({f"{f}.in_w.{i}": (2 * n, n, k),
                           f"{f}.in_b.{i}": (2 * n,),
                           f"{f}.res_skip_w.{i}": (o, n, 1),
                           f"{f}.res_skip_b.{i}": (o,)})
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=generator, device=device)
    t, at = {}, 0
    for name, shape in shapes.items():
        size = math.prod(shape)
        t[name] = flat[at:at + size].view(shape)
        at += size

    def w(x):
        return (0.02 * x).to(dtype).contiguous()

    params = {"upsample_w": w(t["upsample_w"]),
              "upsample_b": w(t["upsample_b"]), "convinv_inv": [], "wn": []}
    for f in range(wc["n_flows"]):
        # An orthogonal Q is its own inverse transpose.
        q, _ = torch.linalg.qr(t[f"{f}.q"].double().cpu())
        params["convinv_inv"].append(q.to(device, dtype).contiguous())
        wn = {key: w(t[f"{f}.{key}"]) for key in
              ("start_w", "start_b", "end_w", "end_b", "cond_w", "cond_b")}
        for key in ("in_w", "in_b", "res_skip_w", "res_skip_b"):
            wn[key] = [w(t[f"{f}.{key}.{i}"]) for i in range(L)]
        params["wn"].append(wn)
    return params
