"""Hyper-parameters of the PyTorch port: a copy of ``gantron_tpu.config.HParams``.

The fields, their defaults, the ``k=v,k=v`` override parser and the
``fp16_run`` -> ``compute_dtype="bfloat16"`` rule are the JAX package's, so a
``--hparams`` string means the same thing to both packages. Fields that only
the JAX package's training or mesh code reads are kept for schema parity and
are inert here. The port keeps its own copy so that it imports nothing of the
JAX package.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
from dataclasses import dataclass, field
from typing import Any, List, Optional


def _split_top_level(s: str) -> list:
    """Split ``k=v,k=v`` on commas NOT inside brackets, so list-valued
    overrides parse: ``mel_buckets=[240,480],batch_size=8`` is two params
    (a naive ``split(",")`` crashed on every multi-element list)."""
    parts, depth, start = [], 0, 0
    for i, ch in enumerate(s):
        if ch in "[(":
            depth += 1
        elif ch in "])":
            depth -= 1
        elif ch == "," and depth == 0:
            if s[start:i]:
                parts.append(s[start:i])
            start = i + 1
    if s[start:]:
        parts.append(s[start:])
    return parts


def _parse_value(value: str) -> Any:
    """Parse a CLI override value the same way the reference does.

    The reference (hparams.py:118-128) keeps values containing ``/`` as raw
    strings (paths) and otherwise tries ``ast.literal_eval`` with a string
    fallback.
    """
    if "/" in value:
        return value
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value


@dataclass
class HParams:
    """Training/model hyper-parameters (schema parity: reference hparams.py)."""

    version: float = 0.6

    epochs: int = 100
    iterations: Optional[int] = None  # if set, stop after this many steps
    iters_per_checkpoint: int = 5000
    sort_pool_batches: int = 8
    validation_audio: bool = True
    validation_sample_diversity: int = 0
    seed: int = 1234
    dynamic_loss_scaling: bool = True
    fp16_run: bool = False  # -> compute_dtype bfloat16
    distributed_run: bool = False
    dist_backend: str = "nccl"
    dist_url: str = "tcp://localhost:54321"
    cudnn_enabled: bool = True
    cudnn_benchmark: bool = False
    ignore_layers: List[str] = field(default_factory=lambda: [
        "decoder.attention_rnn.weight_ih",
        "decoder.attention_layer.memory_layer.linear_layer.weight",
        "decoder.decoder_rnn.weight_ih",
        "decoder.linear_projection.linear_layer.weight",
        "decoder.gate_layer.linear_layer.weight",
    ])
    attn_steps: int = 5000
    reduce_lr_steps_every: float = 5e4
    vesus_path: Optional[str] = None
    speakers_embedding: int = 64
    use_labels: bool = True
    use_noise: bool = False
    use_intended_labels: bool = True

    load_mel_from_disk: bool = False
    training_files: List[str] = field(default_factory=lambda: [
        "filelists/ljs_audio_text_train_filelist.txt",
        "filelists/vesus_train.txt",
    ])
    validation_files: List[str] = field(default_factory=lambda: [
        "filelists/ljs_audio_text_val_filelist.txt",
        "filelists/vesus_val.txt",
    ])
    text_cleaners: List[str] = field(default_factory=lambda: ["english_cleaners"])
    n_labels: int = 5

    max_wav_value: float = 32768.0
    sampling_rate: int = 22050
    filter_length: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    n_ftt: int = 1024  # (sic) name kept for override compatibility
    n_mel_channels: int = 80
    mel_fmin: float = 0.0
    mel_fmax: float = 8000.0

    n_symbols: int = 0  # filled in __post_init__ from the symbol table
    symbols_embedding_dim: int = 512

    encoder_kernel_size: int = 5
    encoder_n_convolutions: int = 3
    encoder_embedding_dim: int = 512

    n_frames_per_step: int = 1
    decoder_rnn_dim: int = 1024
    prenet_dim: int = 256
    max_decoder_steps: int = 500
    gate_threshold: float = 0.5
    p_attention_dropout: float = 0.1
    p_decoder_dropout: float = 0.1

    attention_rnn_dim: int = 1024
    attention_dim: int = 128

    attention_location_n_filters: int = 32
    attention_location_kernel_size: int = 31

    postnet_embedding_dim: int = 512
    postnet_kernel_size: int = 5
    postnet_n_convolutions: int = 5

    discriminator_window: int = 20
    discriminator_dim: int = 512
    g_freq: int = 2
    d_freq: int = 1
    clipping_value: float = 0.001
    gradient_penalty_lambda: float = 0
    noise_size: int = 512
    disc_warmp_up: int = 500  # (sic) name kept for override compatibility
    discriminator_type: str = "conv"
    encoder_inputs: bool = False

    use_saved_learning_rate: bool = False
    g_learning_rate: float = 0.001
    d_learning_rate: float = 0.0007
    weight_decay: float = 1e-6
    grad_clip_thresh: float = 1.0
    batch_size: int = 32
    mask_padding: bool = True

    text_buckets: List[int] = field(default_factory=lambda: [48, 96, 160, 200])
    mel_buckets: List[int] = field(default_factory=lambda: [240, 480, 720, 900])
    mesh_shape: Optional[List[int]] = None
    compute_dtype: str = "float32"  # "bfloat16" when fp16_run is set
    scan_unroll: int = 8
    # Serving: the decoder's four recurrence matrices as per-channel int8,
    # multiplied by the qmm kernel (ops/quant.py) on every decoder step.
    quantized_inference: bool = False
    deferred_dw: bool = True
    adversarial_rollouts: bool = False
    style_reconstruction_weight: float = 0.0
    diversity_weight: float = 0.0
    diversity_tau: float = 10.0
    diversity_cap: float = 0.0
    diversity_subset_redraw: bool = False
    style_code_dims: int = 0
    style_code_levels: int = 0
    code_modularity_weight: float = 0.0
    code_additivity_weight: float = 0.0
    code_orthogonal_reward: bool = False
    identification_warmup: int = 0
    diversity_rescue_floor: float = 0.0
    diversity_rescue_ceiling: float = 0.0
    diversity_rescue_gain: float = 2.0
    diversity_rescue_max: float = 8.0
    factor_rescue_floor: float = 0.0
    factor_rescue_warmup: int = 2000
    factor_rescue_actuator: str = "recon"

    def __post_init__(self):
        if self.n_symbols == 0:
            from gantron_tpu_torch.text.symbols import symbols

            self.n_symbols = len(symbols)
        if self.fp16_run and self.compute_dtype == "float32":
            self.compute_dtype = "bfloat16"

    def add_param(self, param: str, value: Any) -> None:
        fld = getattr(type(self), "__dataclass_fields__", {}).get(param)
        if (fld is not None and isinstance(value, str)
                and "List" in str(fld.type)):
            inner = (value[1:-1] if value[:1] == "[" and value[-1:] == "]"
                     else value)
            value = [p.strip().strip("'\"") for p in inner.split(",")
                     if p.strip()]
        object.__setattr__(self, param, value)

    def add_params_string(self, hparams_string: str) -> None:
        for param in _split_top_level(hparams_string):
            key, value = param.split("=", 1)
            self.add_param(key, _parse_value(value))

    def add_params(self, params) -> None:
        if isinstance(params, str) and "=" in params:
            self.add_params_string(params)
            return
        if isinstance(params, argparse.Namespace):
            params = vars(params)
        hparams_string = None
        for param, value in params.items():
            if param == "hparams":
                hparams_string = value
            elif value is not None:
                self.add_param(param, value)
        if hparams_string is not None:
            self.add_params_string(hparams_string)

    def as_dict(self) -> dict:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}

    @classmethod
    def create(cls, hparams_string: Optional[str] = None) -> "HParams":
        hp = cls()
        if hparams_string:
            hp.add_params_string(hparams_string)
        return hp


@dataclass
class ClassifierHParams:
    """Emotion-classifier hyper-parameters (a copy of the JAX package's
    ``ClassifierHParams``; reference hparams_classifier.py)."""

    epochs: int = 100
    precision: int = 32
    use_labels: str = "intended"  # 'one' | 'intended' | 'multi'
    model_version: str = "0.6.1"

    training_files: List[str] = field(default_factory=lambda: [
        "filelists/vesus_train.txt",
        "filelists/cremad_train.txt",
        "filelists/ravdess_train.txt",
    ])
    validation_files: List[str] = field(default_factory=lambda: [
        "filelists/vesus_val.txt",
        "filelists/cremad_val.txt",
        "filelists/ravdess_val.txt",
    ])
    test_files: List[str] = field(default_factory=lambda: [
        "filelists/vesus_test.txt",
        "filelists/cremad_test.txt",
        "filelists/ravdess_test.txt",
    ])
    n_emotions: int = 5

    sampling_rate: int = 22050
    n_ftt: int = 1024
    hop_length: int = 256
    n_mel_channels: int = 80
    mel_offset: int = 0

    linear_model: bool = True
    model_size: int = 256
    n_frames: int = 80

    lr: float = 0.001
    weight_decay: float = 1e-6
    batch_size: int = 8
    max_noise: int = 5

    add_param = HParams.add_param
    add_params_string = HParams.add_params_string
    add_params = HParams.add_params
    as_dict = HParams.as_dict

    @classmethod
    def create(cls, hparams_string: Optional[str] = None) -> "ClassifierHParams":
        hp = cls()
        if hparams_string:
            hp.add_params_string(hparams_string)
        return hp
