"""Checkpoints with the reference's naming and retention (port of
gantron_tpu/train/checkpoint.py).

Semantics (reference train.py:143-166, 449-465):
  * save every ``iters_per_checkpoint`` as ``iter={i}_val-loss={v}.ckpt``;
  * delete the previous checkpoint when the new val loss improves on it;
  * separately keep the best-ever checkpoint.

A checkpoint is one ``torch.save`` file of everything a bit-exact resume
needs: G's parameters and BatchNorm running statistics, D's parameters,
both Adam states (moments keyed by parameter name), the step count, and the
states of the dropout and noise generators. It is read back with
``torch.load(weights_only=True)``: tensors, dicts and numbers only, no
pickled code. The JAX package's Orbax checkpoints are not read (Orbax
needs JAX); ``utils/jax_weights.py`` carries a JAX state across in-process.

In a data-parallel run only the chief (rank 0) lists and writes
checkpoints: the other processes need not see its disk, and the loop
broadcasts the state the chief restored (parallel/mesh.py::shard_state).
"""

import json
import os
import re
from typing import Optional, Tuple

import torch

from gantron_tpu_torch.parallel.distributed import is_chief
from gantron_tpu_torch.train.state import AdamState
from gantron_tpu_torch.utils.loading import load_checkpoint_tree

_CKPT_RE = re.compile(r"iter=(\d+)_val-loss=([-\d.einf]+)\.ckpt$")


def _cpu(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def _adam_payload(model, opt: AdamState) -> dict:
    names = [n for n, _ in model.named_parameters()]
    return {"count": int(opt.count),
            "mu": {n: _cpu(m) for n, m in zip(names, opt.mu)},
            "nu": {n: _cpu(v) for n, v in zip(names, opt.nu)}}


def _adam_state(model, payload: dict) -> AdamState:
    params = list(model.named_parameters())
    return AdamState(
        int(payload["count"]),
        [payload["mu"][n].to(p.device, p.dtype) for n, p in params],
        [payload["nu"][n].to(p.device, p.dtype) for n, p in params])


def state_payload(state) -> dict:
    """The state as CPU tensors and numbers, keyed by name: a checkpoint's
    payload."""
    return {
        "step": int(state.step),
        "g_state": {k: _cpu(v) for k, v in
                    state.g_model.state_dict().items()},
        "d_state": {k: _cpu(v) for k, v in
                    state.d_model.state_dict().items()},
        "g_opt_state": _adam_payload(state.g_model, state.g_opt_state),
        "d_opt_state": _adam_payload(state.d_model, state.d_opt_state),
        "dropout_generator": state.dropout_generator.get_state(),
        "noise_generator": state.noise_generator.get_state(),
    }


class CheckpointManager:
    """Saves, lists and prunes the checkpoints of one output directory. On
    a process that is not the chief it writes and finds nothing: ``save``
    returns None, ``latest`` and ``best`` return None."""

    def __init__(self, output_directory: str):
        self.output_directory = os.path.abspath(output_directory)
        self.chief = is_chief()
        if self.chief:
            os.makedirs(self.output_directory, exist_ok=True)
        self.prev_check: Optional[str] = None
        self.prev_val_loss = float("inf")
        self.best_val_loss = float("inf")
        self.best_val_loss_path: Optional[str] = None

    def _path(self, iteration: int, val_loss: float) -> str:
        return os.path.join(
            self.output_directory,
            f"iter={iteration}_val-loss={round(val_loss, 6)}.ckpt")

    def save(self, state, iteration: int, val_loss: float,
             extra: Optional[dict] = None) -> Optional[str]:
        if not self.chief:
            return None
        path = self._path(iteration, val_loss)
        # Written whole under a temporary name, then renamed: a run killed
        # mid-save leaves no truncated checkpoint for auto-resume to pick.
        tmp = path + ".tmp"
        torch.save(state_payload(state), tmp)
        os.replace(tmp, path)
        if extra:
            with open(path + ".meta.json", "w") as f:
                json.dump(extra, f)

        # Retention (reference train.py:449-465): drop the previous ckpt if
        # the new val loss improves on it; separately track the best-ever
        # (deleting the superseded best). Sidecar .meta.json files go with
        # their checkpoints or they orphan-accumulate over a long run.
        def _drop(ckpt_path):
            for p in (ckpt_path, ckpt_path + ".meta.json"):
                try:
                    os.remove(p)
                except FileNotFoundError:
                    pass

        if self.prev_check is not None and val_loss < self.prev_val_loss:
            _drop(self.prev_check)
        if val_loss < self.best_val_loss:
            if (self.best_val_loss_path is not None
                    and os.path.exists(self.best_val_loss_path)):
                _drop(self.best_val_loss_path)
            self.best_val_loss = val_loss
            self.best_val_loss_path = path
        self.prev_check = path
        self.prev_val_loss = val_loss
        return path

    def restore(self, path: str, state):
        """Restores the checkpoint into ``state`` (its models in place, its
        Adam states, step and generators replaced) and returns it."""
        payload = load_checkpoint_tree(path)
        state.g_model.load_state_dict(payload["g_state"])
        state.d_model.load_state_dict(payload["d_state"])
        state.g_opt_state = _adam_state(state.g_model,
                                        payload["g_opt_state"])
        state.d_opt_state = _adam_state(state.d_model,
                                        payload["d_opt_state"])
        state.step = int(payload["step"])
        state.dropout_generator.set_state(payload["dropout_generator"])
        state.noise_generator.set_state(payload["noise_generator"])
        return state

    @staticmethod
    def load_meta(path: str) -> Optional[dict]:
        """Side metadata saved next to the checkpoint (learning rates —
        the reference stores them inside the torch dict, train.py:158-166)."""
        meta_path = path + ".meta.json"
        if not os.path.exists(meta_path):
            return None
        with open(meta_path) as f:
            return json.load(f)

    @staticmethod
    def parse_name(path: str) -> Optional[Tuple[int, float]]:
        m = _CKPT_RE.search(os.path.basename(path))
        if not m:
            return None
        return int(m.group(1)), float(m.group(2))

    def latest(self) -> Optional[str]:
        if not self.chief:
            return None
        best = None
        for name in os.listdir(self.output_directory):
            parsed = self.parse_name(name)
            if parsed and (best is None or parsed[0] > best[0]):
                best = (parsed[0], os.path.join(self.output_directory, name))
        return best[1] if best else None

    def best(self) -> Optional[str]:
        """The on-disk checkpoint with the lowest recorded val loss — what
        keep-best retention preserved (the reference tracks the same
        best-ever checkpoint, train.py:455-465). Ties go to the later
        iteration."""
        if not self.chief:
            return None
        best = None
        for name in os.listdir(self.output_directory):
            parsed = self.parse_name(name)
            if parsed is None:
                continue
            key = (parsed[1], -parsed[0])
            if best is None or key < best[0]:
                best = (key, os.path.join(self.output_directory, name))
        return best[1] if best else None


# Reference dotted layer names -> the port's parameter-name prefixes, as the
# JAX package maps them to tree paths (ignore_layers are the
# dataset-dependent layers whose shapes change across conditioning configs;
# reference hparams.py:25-28). The JAX package skips the whole subtree of a
# mapped name (an LSTM's input, hidden and bias weights together), and so
# does the port.
_TORCH_TO_PORT = {
    "decoder.attention_rnn.weight_ih": "decoder.attention_rnn",
    "decoder.attention_layer.memory_layer.linear_layer.weight":
        "decoder.memory_w",
    "decoder.decoder_rnn.weight_ih": "decoder.decoder_rnn",
    "decoder.linear_projection.linear_layer.weight": "decoder.proj_w",
    "decoder.gate_layer.linear_layer.weight": "decoder.gate_w",
    "embedding.weight": "embedding",
}


def warm_start_filter(g_state, restored_g_state, ignore_layers):
    """Generator-weights-only warm start (reference train.py:128-140).

    Name-wise merge of two ``state_dict``s: for each entry of the NEW model,
    take the restored value when the name exists in the checkpoint, shapes
    match, and the name is not under an ignored prefix -- otherwise keep the
    fresh one. Works across configs whose conditioning dims differ (the
    whole point of ``ignore_layers``). BatchNorm running statistics are
    entries too, so they carry over as the reference's load_state_dict
    carries them.
    """
    skip = [_TORCH_TO_PORT[l] for l in ignore_layers if l in _TORCH_TO_PORT]

    def merged(name, new):
        if any(name == p or name.startswith(p + ".") for p in skip):
            return new
        restored = restored_g_state.get(name)
        if restored is None or tuple(restored.shape) != tuple(new.shape):
            return new
        return restored.to(new.device, new.dtype)

    return {name: merged(name, new) for name, new in g_state.items()}
