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

There is no path from a CUDA tensor to the plain version. Both are the two
implementations of one registered operator, ``torch.ops.gantron_tpu_torch.qmm``
(``torch.library``, defined when this module is imported), whose fake
implementation gives the ``(B, O)`` output in ``x.dtype``: so the decode
traces through ``torch.export`` with the product as one node, and a loaded
program calls the kernel on the card. The op is defined with
``torch.library.Library`` and called through its ``OpOverload``, the
thinnest binding: ``torch.library.custom_op`` would add its own Python
wrapper to each of the decode step's four calls, and the step is bound by
the host.
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


def _qmm_cuda(x: torch.Tensor, q: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """The op's CUDA implementation: checks, then one launch of
    ``csrc/qmm.cu`` on the current stream, or raises."""
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


def _qmm_cpu(x: torch.Tensor, q: torch.Tensor,
             scale: torch.Tensor) -> torch.Tensor:
    return qmatmul(x, QuantizedMatrix(q, scale))


def _qmm_fake(x: torch.Tensor, q: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    return x.new_empty((x.shape[0], q.shape[1]))


_LIB = torch.library.Library("gantron_tpu_torch", "DEF")
_LIB.define("qmm(Tensor x, Tensor q, Tensor scale) -> Tensor")
_LIB.impl("qmm", _qmm_cuda, "CUDA")
_LIB.impl("qmm", _qmm_cpu, "CPU")
torch.library.register_fake("gantron_tpu_torch::qmm", _qmm_fake, lib=_LIB)
_QMM = torch.ops.gantron_tpu_torch.qmm.default


def qmm(x: torch.Tensor, qm: QuantizedMatrix) -> torch.Tensor:
    """x @ dequantize(qm) through the registered op: the kernel for CUDA
    tensors, ``qmatmul`` for CPU tensors. ``qmm.launches`` counts kernel
    launches."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"qmm: unsupported device {x.device}")
    return _QMM(x, qm.q, qm.scale)


qmm.launches = 0


def matmul_rhs(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` for a plain matrix, ``qmm`` for a QuantizedMatrix."""
    if isinstance(w, QuantizedMatrix):
        return qmm(x, w)
    return x @ w
