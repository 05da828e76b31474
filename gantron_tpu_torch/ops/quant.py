"""Int8 weight streaming for the decoder's recurrence matrices
(port of gantron_tpu/ops/quant.py).

Every decoder step multiplies a small batch of activations by the four large
recurrence matrices (attention-LSTM context and hidden, decoder-LSTM input and
hidden). With ``hp.quantized_inference`` those matrices are stored as
per-output-channel symmetric int8, and each product goes through ``qmm``:

  * on a CUDA tensor, ``qmm`` launches the hand-written kernel ``csrc/qmm.cu``
    (built with ``nvcc`` at first use) or raises;
  * on a CPU tensor, it computes the same function with ``qmatmul``, the plain
    PyTorch version.

There is no path from a CUDA tensor to the plain version.
"""

import ctypes
import functools
from typing import NamedTuple

import torch


class QuantizedMatrix(NamedTuple):
    """Per-output-channel symmetric int8 weight: w ~= q * scale[None, :]."""

    q: torch.Tensor      # (I, O) int8
    scale: torch.Tensor  # (O,) float32


def quantize_per_channel(w: torch.Tensor) -> QuantizedMatrix:
    """(I, O) float -> QuantizedMatrix with per-column symmetric scales."""
    w = w.float()
    amax = w.abs().amax(dim=0)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scale[None, :]), -127, 127)
    return QuantizedMatrix(q=q.to(torch.int8).contiguous(), scale=scale)


def dequantize(qm: QuantizedMatrix, dtype=torch.float32) -> torch.Tensor:
    return (qm.q.float() * qm.scale[None, :]).to(dtype)


def qmatmul(x: torch.Tensor, qm: QuantizedMatrix) -> torch.Tensor:
    """Plain version of the kernel: x (..., I) -> (..., O) in x.dtype, the
    int8 weights widened, products summed in float32, scale after the sum."""
    acc = x.float() @ qm.q.float()
    return (acc * qm.scale).to(x.dtype)


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib():
    """The built kernel library with its C signatures declared (without
    argtypes ctypes would pass each pointer as a 32-bit int and cut it)."""
    from gantron_tpu_torch.utils.cuda_build import load_library

    lib = load_library("qmm")
    lib.qmm_launch.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                               + [ctypes.c_void_p])
    lib.qmm_launch.restype = ctypes.c_int
    lib.qmm_error_string.argtypes = [ctypes.c_int]
    lib.qmm_error_string.restype = ctypes.c_char_p
    return lib


def qmm(x: torch.Tensor, qm: QuantizedMatrix) -> torch.Tensor:
    """x @ dequantize(qm): the kernel for CUDA tensors, ``qmatmul`` for CPU
    tensors. ``qmm.launches`` counts kernel launches."""
    if x.device.type == "cpu":
        return qmatmul(x, qm)
    if x.device.type != "cuda":
        raise ValueError(f"qmm: unsupported device {x.device}")
    q, scale = qm
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"qmm: x must be float32 or bfloat16, got {x.dtype}")
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"qmm: q must be int8 and scale float32, got "
                        f"{q.dtype} and {scale.dtype}")
    if x.dim() != 2 or q.dim() != 2 or scale.shape != (q.shape[1],) \
            or x.shape[1] != q.shape[0]:
        raise ValueError(f"qmm: shapes x {tuple(x.shape)}, q "
                         f"{tuple(q.shape)}, scale {tuple(scale.shape)} do "
                         "not form (B, I) @ (I, O) * (O,)")
    if q.device != x.device or scale.device != x.device:
        raise ValueError("qmm: x, q and scale must be on one device")
    if not (x.is_contiguous() and q.is_contiguous()
            and scale.is_contiguous()):
        raise ValueError("qmm: x, q and scale must be contiguous")
    (B, I), O = x.shape, q.shape[1]
    y = torch.empty((B, O), dtype=x.dtype, device=x.device)
    args = (x.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(), B, I,
            O, _DTYPE_CODE[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    lib = _lib()
    if x.device.index == torch.cuda.current_device():
        err = lib.qmm_launch(*args)
    else:
        with torch.cuda.device(x.device):
            err = lib.qmm_launch(*args)
    if err != 0:
        raise RuntimeError("qmm kernel launch failed: "
                           + lib.qmm_error_string(err).decode())
    qmm.launches += 1
    return y


qmm.launches = 0


def matmul_rhs(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` for a plain matrix, ``qmm`` for a QuantizedMatrix."""
    if isinstance(w, QuantizedMatrix):
        return qmm(x, w)
    return x @ w
