"""Serving export (port of gantron_tpu/export.py): the inference graph as one
``torch.export`` artifact.

The whole text -> mel computation (text -> wav when a WaveGlow is given): the
encoder, the decoder as one ``while_loop`` over ``max_decoder_steps``
(``Decoder.infer_loop``: exactly that many steps, no early exit, the lengths
returned), the postnet and WaveGlow's inverse flow, is exported with
``torch.export.export`` and saved with ``torch.export.save``. The exported
program holds the weights (with ``hp.quantized_inference``, the four int8
recurrence matrices and their scales). A server loads the file and calls it;
it needs no model code and no checkpoint.

Shapes are static by default: pad text to the export length (``pad_text``);
the returned lengths say where each decode stopped. ``batch_size=None`` and
``text_len=None`` export ``torch.export.Dim``s instead, as the JAX export's
symbolic shapes do: one file serves any batch size and text length (the
encoder's BiLSTM then runs as a ``while_loop`` over the symbolic length).

Where the torch artifact differs from the JAX one:

  * Randomness. Prenet dropout, the style draw (and the emotions' draw of a
    labelled model given none) and WaveGlow's ``z`` come from the default
    generators, since an exported program can take no ``torch.Generator``.
    ``load_exported``'s function seeds them from its ``seed`` argument inside
    ``torch.random.fork_rng``: the counterpart of the JAX artifact's ``key``.
  * The op library. With ``hp.quantized_inference`` the program calls
    ``torch.ops.gantron_tpu_torch.qmm``, so loading it needs
    ``gantron_tpu_torch.ops.quant`` imported (``load_exported`` imports it);
    the JAX artifact holds its Pallas kernel and needs no package.
  * Devices. The JAX package's rule that a quantized artifact serves one
    platform comes from how Pallas lowers; it does not carry over. A torch
    program runs on the device it was exported on, and ``load_exported``
    refuses tensors that lie elsewhere.
"""

import os
from typing import Optional

import numpy as np
import torch
from torch import nn

from gantron_tpu_torch.ops import quant
from gantron_tpu_torch.utils.device import resolve_device

_BIG = ("wc", "wh1", "w2ih", "w2hh")


class _Infer(nn.Module):
    """The exported function as a module: text ids and their true lengths
    (and, for a VESUS model, emotions and speaker ids) -> (postnet mel or
    waveform, lengths in frames)."""

    def __init__(self, model, max_steps, waveglow, sigma):
        super().__init__()
        self.model = model
        self.max_steps = max_steps or model.hp.max_decoder_steps
        self.waveglow, self.sigma = waveglow, sigma
        self.quantized = bool(model.hp.quantized_inference)
        if self.quantized:
            # Quantized once, here: the program holds int8 matrices.
            W = model.decoder._scan_weights(quantize=True)
            for name in _BIG:
                qm = getattr(W, name)
                self.register_buffer(f"{name}_q", qm.q)
                self.register_buffer(f"{name}_scale", qm.scale)

    def _scan_weights(self):
        W = self.model.decoder._scan_weights()
        if not self.quantized:
            return W
        return W._replace(**{name: quant.QuantizedMatrix(
            getattr(self, f"{name}_q"), getattr(self, f"{name}_scale"))
            for name in _BIG})

    def forward(self, text_ids, text_lengths, emotions=None, speaker=None):
        model = self.model
        memory = model.encode_memory(text_ids, None, emotions, speaker,
                                     text_lengths)
        mel, _, _, lengths = model.decoder.infer_loop(
            memory, self.max_steps, text_lengths.to(memory.device, torch.long),
            self._scan_weights())
        mel_post = mel + model.postnet(mel)
        if self.waveglow is None:
            return mel_post, lengths
        return self.waveglow.infer(mel_post, self.sigma), lengths


def make_infer_fn(model, max_steps: Optional[int] = None, waveglow=None,
                  sigma: float = 0.666):
    """``(fn, conditioned)``: ``fn(text_ids, text_lengths[, emotions,
    speaker]) -> (out, lengths)``, where ``out`` is the postnet mel
    (B, n_mel, S*K), or the waveform when ``waveglow`` is given, and
    ``conditioned = bool(hp.vesus_path)`` says whether ``fn`` takes
    emotions (B, 5) and speaker ids (B,). ``text_lengths`` are the TRUE
    lengths of the padded ``text_ids``: the mask keeps the encoder and the
    attention off the pad positions. Its draws come from the default
    generators; call it under ``torch.random.fork_rng`` with
    ``torch.manual_seed`` to repeat them, as ``load_exported`` does."""
    fn = _Infer(model, max_steps, waveglow, sigma).eval()
    return fn, bool(model.hp.vesus_path)


def _example_args(device, B, T, conditioned):
    args = [torch.ones((B, T), dtype=torch.long, device=device),
            torch.full((B,), T, dtype=torch.long, device=device)]
    if conditioned:
        args += [torch.zeros((B, 5), device=device),
                 torch.zeros((B,), dtype=torch.long, device=device)]
    return tuple(args)


def _free_sizes(fn, n=2):
    """``n`` example sizes for symbolic dimensions that no weight of ``fn``
    has as a dimension. The ``while_loop`` bodies are traced with every
    size a symbol and sizes that are equal share one; a weight's dimension
    is then fixed, and a batch or text length equal to it would be fixed
    with it."""
    taken = {1, fn.max_steps}
    tensors = list(fn.state_dict().values())
    if fn.waveglow is not None:
        tensors += [t for t in _leaves(fn.waveglow.params)]
    for t in tensors:
        taken.update(t.shape)
    sizes, k = [], 2
    while len(sizes) < n:
        if k not in taken:
            sizes.append(k)
        k += 1
    return sizes


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in _leaves(item)]
    return [tree]


def export_tts(model, path: str, batch_size: Optional[int] = 1,
               text_len: Optional[int] = 96, max_steps: Optional[int] = None,
               waveglow=None, sigma: float = 0.666, device="cuda") -> int:
    """Export ``model``'s inference graph (weights held by the program) to
    ``path`` with ``torch.export.save``; returns the artifact's bytes.

    ``batch_size`` / ``text_len``: the export's static shape, or None for a
    ``torch.export.Dim``. ``device``: where the program runs; the model's
    weights (and WaveGlow's) must be there already, since a program runs on
    the device it was exported on."""
    # "cuda" as the device the weights report, "cuda:0".
    device = torch.empty(0, device=resolve_device(device)).device
    on = [model.device] + ([waveglow.device] if waveglow is not None else [])
    if any(d != device for d in on):
        raise ValueError(f"export_tts: the weights are on {on}, not on "
                         f"{device}; a program runs where its weights are, "
                         "so move the model first")
    fn, conditioned = make_infer_fn(model, max_steps, waveglow, sigma)
    B_free, T_free = _free_sizes(fn)
    B = batch_size if batch_size is not None else B_free
    T = text_len if text_len is not None else T_free
    args = _example_args(device, B, T, conditioned)
    b_dim = (torch.export.Dim("batch", min=1, max=1024)
             if batch_size is None else torch.export.Dim.STATIC)
    t_dim = (torch.export.Dim("text_len", min=2, max=4096)
             if text_len is None else torch.export.Dim.STATIC)
    shapes = [{0: b_dim, 1: t_dim}, {0: b_dim}]
    if conditioned:
        shapes += [{0: b_dim}, {0: b_dim}]
    # The while_loop bodies are traced by dynamo; sizes it saw in earlier
    # traces would be taken as static here.
    torch._dynamo.reset()
    with torch.no_grad():
        program = torch.export.export(fn, args, dynamic_shapes=tuple(shapes))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.export.save(program, path, extra_files={
        "device": str(device), "conditioned": str(int(conditioned))})
    return os.path.getsize(path)


def seeded_call(fn, seed: int, device, *args):
    """``fn(*args)`` without autograd, with the default generators (the
    CPU's and ``device``'s) seeded from ``seed`` inside
    ``torch.random.fork_rng``, so the caller's generators are left as they
    were."""
    device = torch.device(device)
    cards = [device.index or 0] if device.type == "cuda" else []
    with torch.random.fork_rng(devices=cards), torch.no_grad():
        torch.manual_seed(int(seed))
        return fn(*args)


def load_exported(path: str):
    """Load an artifact of ``export_tts``; returns ``fn(text_ids,
    text_lengths, seed[, emotions, speaker]) -> (out, lengths)``, which runs
    the program on the device it was exported for, with the default
    generators seeded from ``seed`` (``seeded_call``). Array-likes are
    moved to that device; a tensor on another device is refused
    (ValueError). The weights are inside the artifact; unlike the JAX
    artifact it needs the op library: importing this module imports
    ``gantron_tpu_torch.ops.quant``, which registers
    ``torch.ops.gantron_tpu_torch.qmm``."""
    extra = {"device": "", "conditioned": ""}
    program = torch.export.load(path, extra_files=extra)
    module = program.module()
    device = torch.device(extra["device"])

    def put(x, dtype):
        if isinstance(x, torch.Tensor) and x.device != device:
            raise ValueError(f"load_exported: an input is on {x.device}, but "
                             f"the program runs on {device}, where it was "
                             "exported")
        return torch.as_tensor(x, dtype=dtype, device=device)

    def fn(text_ids, text_lengths, seed, emotions=None, speaker=None):
        args = [put(text_ids, torch.long), put(text_lengths, torch.long)]
        if emotions is not None:
            args += [put(emotions, torch.float32), put(speaker, torch.long)]
        return seeded_call(module, seed, device, *args)

    fn.conditioned = extra["conditioned"] == "1"
    fn.device = device
    return fn


def pad_text(ids, text_len: int) -> np.ndarray:
    """Zero-pad (or reject over-length) token ids to the exported length."""
    ids = np.atleast_2d(np.asarray(ids, np.int64))
    if ids.shape[1] > text_len:
        raise ValueError(f"text length {ids.shape[1]} exceeds the exported "
                         f"static length {text_len}")
    out = np.zeros((ids.shape[0], text_len), np.int64)
    out[:, :ids.shape[1]] = ids
    return out
