"""Recurrent primitives (port of gantron_tpu/ops/rnn.py).

  * ``lstm_cell``     -- one LSTMCell step (torch gate order i, f, g, o).
  * ``lstm_scan``     -- length-masked unidirectional LSTM over (B, T, D).
  * ``masked_bilstm`` -- the packed-sequence bidirectional LSTM: the backward
    direction starts at each sequence's true last frame, and outputs beyond
    each length are zero (as pack_padded / pad_packed give).

Weights keep the JAX package's layout, ``w_ih (D, 4H)``, ``w_hh (H, 4H)`` and
one summed bias ``b (4H,)`` (torch's ``b_ih + b_hh``), so ``x @ w_ih`` reads
as it does there.
"""

import math

import torch
from torch import nn


class LSTMParams(nn.Module):
    """LSTM weights, torch LSTMCell's default init U(-1/sqrt(H), 1/sqrt(H))
    with the bias the sum of two such draws."""

    def __init__(self, input_dim: int, hidden: int,
                 generator: torch.Generator = None):
        super().__init__()
        bound = 1.0 / math.sqrt(hidden)

        def u(*shape):
            return (torch.rand(shape, generator=generator) * 2 - 1) * bound

        self.w_ih = nn.Parameter(u(input_dim, 4 * hidden))
        self.w_hh = nn.Parameter(u(hidden, 4 * hidden))
        self.b = nn.Parameter(u(4 * hidden) + u(4 * hidden))


def gates_to_state(gates, c):
    """LSTM state update from pre-activation gates (B, 4H) and cell c."""
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def lstm_cell(params, x, h, c):
    """One step; ``params`` has ``w_ih``, ``w_hh`` and ``b``."""
    return gates_to_state(x @ params.w_ih + h @ params.w_hh + params.b, c)


def _masked_step(params, x_t, h, c, valid):
    """One step of ``lstm_scan``: (h, c, output); ``valid`` (B, 1) or None."""
    h_new, c_new = gates_to_state(x_t + h @ params.w_hh, c)
    if valid is None:
        return h_new, c_new, h_new
    return (torch.where(valid, h_new, h), torch.where(valid, c_new, c),
            torch.where(valid, h_new, 0.0))


def _lstm_scan_loop(params, x_proj, lengths):
    """``lstm_scan``'s loop as a ``torch._higher_order_ops.while_loop``, for
    a symbolic T (``torch.export`` with a dynamic text length), where a
    Python loop would fix T at the traced value."""
    from torch._higher_order_ops import while_loop

    B, T, _ = x_proj.shape
    H = params.w_hh.shape[0]

    def body(t, h, c, out):
        x_t = x_proj.index_select(1, t.reshape(1))[:, 0]
        valid = None if lengths is None else (t < lengths)[:, None]
        h, c, y = _masked_step(params, x_t, h, c, valid)
        return t + 1, h, c, out.index_copy(1, t.reshape(1), y[:, None])

    t0 = torch.zeros((), dtype=torch.long, device=x_proj.device)
    carry = (t0, x_proj.new_zeros(B, H), x_proj.new_zeros(B, H),
             x_proj.new_zeros(B, T, H))
    return while_loop(lambda t, *_: t < T, body, carry)[3]


def lstm_scan(params, xs, lengths=None):
    """xs: (B, T, D); lengths: (B,) or None. Beyond a sequence's length the
    state is held and the output is zero. Returns (B, T, H)."""
    B, T, _ = xs.shape
    H = params.w_hh.shape[0]
    x_proj = xs @ params.w_ih + params.b  # input projection out of the loop
    if isinstance(T, torch.SymInt):
        return _lstm_scan_loop(params, x_proj, lengths)
    h = xs.new_zeros(B, H)
    c = xs.new_zeros(B, H)
    outs = []
    for t in range(T):
        valid = None if lengths is None else (t < lengths)[:, None]
        h, c, y = _masked_step(params, x_proj[:, t], h, c, valid)
        outs.append(y)
    return torch.stack(outs, dim=1)


def _reverse_valid(xs, lengths):
    """out[b, t] = xs[b, len_b - 1 - t] for t < len_b, else 0."""
    B, T, D = xs.shape
    t = torch.arange(T, device=xs.device)[None, :]
    idx = torch.clamp(lengths[:, None] - 1 - t, 0, T - 1)
    out = torch.gather(xs, 1, idx[..., None].expand(B, T, D))
    return torch.where((t < lengths[:, None])[..., None], out, 0.0)


def masked_bilstm(params_fw, params_bw, xs, lengths):
    """Bidirectional LSTM equal to torch's packed BiLSTM. Returns (B, T, 2H),
    zero beyond each sequence's length."""
    fw = lstm_scan(params_fw, xs, lengths)
    bw_rev = lstm_scan(params_bw, _reverse_valid(xs, lengths), lengths)
    return torch.cat([fw, _reverse_valid(bw_rev, lengths)], dim=-1)
