"""Recurrent ops: the fused ``RNN`` op and ``_state_zeros``.

PyTorch counterpart of ``mxnet_tpu/ops/rnn.py`` (reference:
src/operator/rnn-inl.h, the cuDNN path src/operator/cudnn_rnn-inl.h).  The
reference runs each layer and direction as one ``lax.scan``; here it is
plain torch: one input projection ``x @ Wx.T + bx`` over all steps, then a
Python loop over the steps (one ``h @ Wh.T`` and the gate arithmetic a
step), so autograd differentiates the recurrence.  No cuDNN RNN and no
``torch.nn.LSTM``: the reference's lax.scan is no Pallas kernel, so the
op has no hand-written kernel either.

The parameter blob is the reference's flat layout (cuDNN's canonical
order: every layer's and direction's i2h then h2h weights, then their
i2h and h2h biases; gates LSTM i, f, g, o and GRU r, z, n), so parameter
files and ``FusedRNNCell.unpack_weights`` agree across packages.
"""
from __future__ import annotations

import torch

from ..base import torch_dtype
from .random_ops import bernoulli_mask
from .registry import register
from .sampling import threefry2x32

__all__ = ["rnn", "rnn_param_size", "state_zeros"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def _cell_step(mode, x_proj, h, c, Wh, bh):
    """One recurrent step given the step's input projection ``x_proj``."""
    h_proj = torch.addmm(bh, h, Wh.t())
    if mode == "lstm":
        i, f, g, o = torch.chunk(x_proj + h_proj, 4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c_new), c_new
    if mode == "gru":
        xr, xz, xn = torch.chunk(x_proj, 3, dim=-1)
        hr, hz, hn = torch.chunk(h_proj, 3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        return (1 - z) * n + z * h, c
    act = torch.tanh if mode == "rnn_tanh" else torch.relu
    return act(x_proj + h_proj), c


def _layer_scan(mode, x, h0, c0, Wx, Wh, bx, bh, reverse=False):
    """One direction of one layer over x (T, N, I): outputs (T, N, H) in
    input order, and the final h and c."""
    T = x.shape[0]
    x_proj = torch.matmul(x, Wx.t()) + bx    # one product over all steps
    h, c = h0, c0
    ys = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        h, c = _cell_step(mode, x_proj[t], h, c, Wh, bh)
        ys[t] = h
    return torch.stack(ys), h, c


def _unpack_params(parameters, mode, num_layers, input_size, state_size,
                   bidirectional):
    """Views of the flat blob: [(Wx, Wh)] and [(bx, bh)] per layer and
    direction."""
    ng = _GATES[mode]
    dirs = 2 if bidirectional else 1
    G = ng * state_size
    ptr = 0
    Ws, Bs = [], []
    for layer in range(num_layers):
        isz = input_size if layer == 0 else state_size * dirs
        for _ in range(dirs):
            Wx = parameters[ptr:ptr + G * isz].view(G, isz)
            ptr += G * isz
            Wh = parameters[ptr:ptr + G * state_size].view(G, state_size)
            ptr += G * state_size
            Ws.append((Wx, Wh))
    for _ in range(num_layers * dirs):
        bx = parameters[ptr:ptr + G]
        bh = parameters[ptr + G:ptr + 2 * G]
        ptr += 2 * G
        Bs.append((bx, bh))
    return Ws, Bs


def rnn_param_size(mode, num_layers, input_size, state_size,
                   bidirectional=False):
    ng = _GATES[mode]
    dirs = 2 if bidirectional else 1
    total = 0
    for layer in range(num_layers):
        isz = input_size if layer == 0 else state_size * dirs
        total += (ng * state_size * (isz + state_size)
                  + 2 * ng * state_size) * dirs
    return total


@register("_state_zeros")
def state_zeros(data, num_hidden=0, dtype="float32"):
    """zeros((batch of ``data``, num_hidden)): the begin state of an
    unrolled cell, its batch taken from the step input inside the graph
    (the reference's unknown-batch ``begin_state`` shape (0, H))."""
    return torch.zeros((data.shape[0], int(num_hidden)),
                       dtype=torch_dtype(dtype), device=data.device)


def _fold_in(rng_key, data: int):
    """``jax.random.fold_in`` of an int64 two-word key tensor."""
    zero = torch.zeros_like(rng_key[0])
    w0, w1 = threefry2x32(rng_key[0], rng_key[1], zero, zero + int(data))
    return torch.stack([w0, w1])


@register("RNN", rng=True, num_outputs=lambda attrs: (
    1 if not attrs.get("state_outputs")
    else (3 if attrs.get("mode", "lstm") == "lstm" else 2)))
def rnn(data, parameters, state, state_cell=None, rng_key=None, state_size=0,
        num_layers=1, mode="lstm", bidirectional=False, p=0.0,
        state_outputs=False, projection_size=None, lstm_state_clip_min=None,
        lstm_state_clip_max=None, lstm_state_clip_nan=False, _training=True):
    """Fused multi-layer (bidirectional) RNN (reference: src/operator/rnn.cc
    ``RNN``).  data (T, N, I); state (and an LSTM's state_cell)
    (L*dirs, N, H); parameters the flat blob.  Between layers, while
    training with ``p > 0``, the output is multiplied by
    ``bernoulli(fold_in(rng_key, layer), 1 - p) / (1 - p)``.
    ``projection_size`` and the ``lstm_state_clip_*`` arguments are
    accepted and ignored, as the reference does."""
    T, N, I = data.shape
    H = int(state_size)
    L = int(num_layers)
    dirs = 2 if bidirectional else 1
    Ws, Bs = _unpack_params(parameters, mode, L, I, H, bidirectional)
    if state_cell is None:
        state_cell = torch.zeros_like(state)
    p = float(p)
    x = data
    hTs, cTs = [], []
    for layer in range(L):
        outs = []
        for d in range(dirs):
            idx = layer * dirs + d
            ys, hT, cT = _layer_scan(mode, x, state[idx], state_cell[idx],
                                     *Ws[idx], *Bs[idx], reverse=(d == 1))
            outs.append(ys)
            hTs.append(hT)
            cTs.append(cT)
        x = outs[0] if dirs == 1 else torch.cat(outs, dim=-1)
        if p > 0.0 and _training and layer < L - 1 and rng_key is not None:
            keep = 1.0 - p
            mask = bernoulli_mask(_fold_in(rng_key, layer), keep,
                                  tuple(x.shape)).to(x.dtype)
            x = x * mask / keep
    if not state_outputs:
        return x
    hT = torch.stack(hTs)
    if mode == "lstm":
        return x, hT, torch.stack(cTs)
    return x, hT
