"""Recurrent ops: LSTM / GRU / simple RNN over padded batches, the port of
``paddle_tpu/ops/rnn.py``.

Parity targets: operators/lstm_op.cc, gru_op.cc, lstmp_op.cc,
cudnn_lstm_op.cu.cc and the math kernels operators/math/lstm_compute.cc /
gru_compute.cc. Sequences are dense-padded [B, T, D] with an optional
lengths vector. The JAX package runs the recurrence as a ``lax.scan``;
here the input projection is hoisted into one matmul and the recurrence
is a Python loop over T, each step a handful of ops on the card (about
10-15 launches a step, forward) with the mask a float tensor: no step
reads a value on the host.

Conventions are the JAX package's, not ``torch.nn.LSTM``'s / cuDNN's: LSTM
gate order i,f,c,o with the peepholes w_ic, w_fc on c and w_oc on the new
c; GRU gate order update, reset, candidate with the reset applied BEFORE
the recurrent product, ``tanh(xc + (r * h) @ w_c)`` (Paddle's, where
PyTorch's GRU takes ``r * (h @ W)``); a padded step carries the state
through as ``m * new + (1 - m) * old`` and outputs ``new * m``.
"""

import torch

__all__ = ["lstm", "dynamic_lstm", "dynamic_lstmp", "gru", "dynamic_gru",
           "simple_rnn", "bidirectional_lstm", "attention_lstm"]


def _mask_from_lengths(lengths, T, device):
    if lengths is None:
        return None
    lengths = torch.as_tensor(lengths, device=device)
    return (torch.arange(T, device=device)[None, :]
            < lengths[:, None]).to(torch.float32)


def _project(x, w_ih, b, width):
    B, T, D = x.shape
    xp = x if w_ih is None else (x.reshape(B * T, D) @ w_ih)
    if b is not None:
        xp = xp + b
    return xp.reshape(B, T, width)


def _steps(xp, mask):
    """Per step (x_t [B, W], m_t [B, 1] or None)."""
    T = xp.shape[1]
    return [(xp[:, t], None if mask is None else mask[:, t, None])
            for t in range(T)]


def lstm(x, w_ih, w_hh, b=None, h0=None, c0=None, lengths=None,
         reverse=False, peepholes=None):
    """Single-layer LSTM. x: [B,T,D]; w_ih: [D,4H], or None when x is
    already projected [B,T,4H]; w_hh: [H,4H]; b: [4H]. Gate order i,f,c,o
    (ref: operators/math/lstm_compute.h). peepholes: optional [3H] (w_ic,
    w_fc, w_oc: elementwise cell-to-gate weights, the reference's
    use_peepholes=True default, ref: operators/lstm_op.cc:75-83). Returns
    (outputs [B,T,H], (h_T, c_T)). Padded steps (t >= lengths[b]) carry the
    state through unchanged and output 0."""
    B, T, D = x.shape
    H = w_hh.shape[0]
    h = h0 if h0 is not None else x.new_zeros((B, H))
    c = c0 if c0 is not None else x.new_zeros((B, H))
    mask = _mask_from_lengths(lengths, T, x.device)
    if peepholes is not None:
        w_ic, w_fc, w_oc = torch.chunk(peepholes, 3)
    xp = _project(x, w_ih, b, 4 * H)
    if reverse:
        xp = torch.flip(xp, dims=[1])
        mask = torch.flip(mask, dims=[1]) if mask is not None else None
    outs = []
    for xt, m in _steps(xp, mask):
        gates = xt + h @ w_hh
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        if peepholes is not None:
            i = i + w_ic * c
            f = f + w_fc * c
        i, f = torch.sigmoid(i), torch.sigmoid(f)
        g = torch.tanh(g)
        c_new = f * c + i * g
        if peepholes is not None:
            o = o + w_oc * c_new
        o = torch.sigmoid(o)
        h_new = o * torch.tanh(c_new)
        if m is not None:
            c_new = m * c_new + (1 - m) * c
            h_new = m * h_new + (1 - m) * h
            outs.append(h_new * m)
        else:
            outs.append(h_new)
        h, c = h_new, c_new
    out = torch.stack(outs, dim=1)
    if reverse:
        out = torch.flip(out, dims=[1])
    return out, (h, c)


def dynamic_lstm(input, w_hh, bias=None, h0=None, c0=None, lengths=None,
                 is_reverse=False, use_peepholes=True, name=None):
    """fluid.layers.dynamic_lstm parity (ref: operators/lstm_op.cc): input
    is the *projected* x@W [B,T,4H]; w_hh [H,4H]. With use_peepholes=True
    (the reference default) a [7H] bias is the 4H gate biases then the 3H
    peephole weights w_ic, w_fc, w_oc. The activations are fixed (sigmoid
    gates, tanh candidate and cell), as in the JAX package."""
    H = w_hh.shape[0]
    peep = None
    b = bias
    if use_peepholes and bias is not None:
        bias = torch.flatten(bias)
        if bias.shape[0] == 7 * H:
            b, peep = bias[:4 * H], bias[4 * H:]
        elif bias.shape[0] == 4 * H:
            b = bias          # gate biases only; no peephole weights given
        else:
            raise ValueError(
                f"dynamic_lstm bias must be [4H]={4*H} or (with "
                f"use_peepholes) [7H]={7*H}, got {bias.shape[0]}")
    return lstm(input, None, w_hh, b=b, h0=h0, c0=c0, lengths=lengths,
                reverse=is_reverse, peepholes=peep)


def dynamic_lstmp(input, w_hh, w_proj, bias=None, lengths=None,
                  is_reverse=False, name=None):
    """LSTM with a recurrent projection (ref: operators/lstmp_op.cc): the
    hidden H is projected to P each step; w_hh: [P,4H], w_proj: [H,P].
    Returns (outputs [B,T,P], (r_T, c_T))."""
    B, T, fourH = input.shape
    H = fourH // 4
    P_ = w_proj.shape[1]
    mask = _mask_from_lengths(lengths, T, input.device)
    xp = input + bias if bias is not None else input
    if is_reverse:
        xp = torch.flip(xp, dims=[1])
        mask = torch.flip(mask, dims=[1]) if mask is not None else None
    r, c = input.new_zeros((B, P_)), input.new_zeros((B, H))
    outs = []
    for xt, m in _steps(xp, mask):
        gates = xt + r @ w_hh
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        c_new = f * c + i * torch.tanh(g)
        h_new = o * torch.tanh(c_new)
        r_new = h_new @ w_proj
        if m is not None:
            c_new = m * c_new + (1 - m) * c
            r_new = m * r_new + (1 - m) * r
            outs.append(r_new * m)
        else:
            outs.append(r_new)
        r, c = r_new, c_new
    out = torch.stack(outs, dim=1)
    if is_reverse:
        out = torch.flip(out, dims=[1])
    return out, (r, c)


def gru(x, w_ih, w_hh, b=None, h0=None, lengths=None, reverse=False,
        origin_mode=False):
    """Single-layer GRU. x: [B,T,D]; w_ih: [D,3H], or None when x is
    projected [B,T,3H]; w_hh: [H,3H], gate order update, reset, candidate
    (ref: operators/math/gru_compute.cc), the reset applied before the
    recurrent product. origin_mode=False (the reference's dynamic_gru
    default): h = (1-u)*h + u*c; origin_mode=True: h = u*h + (1-u)*c.
    Returns (outputs [B,T,H], h_T)."""
    B, T, D = x.shape
    H = w_hh.shape[0]
    h = h0 if h0 is not None else x.new_zeros((B, H))
    mask = _mask_from_lengths(lengths, T, x.device)
    xp = _project(x, w_ih, b, 3 * H)
    if reverse:
        xp = torch.flip(xp, dims=[1])
        mask = torch.flip(mask, dims=[1]) if mask is not None else None
    w_uz, w_c = w_hh[:, :2 * H], w_hh[:, 2 * H:]
    outs = []
    for xt, m in _steps(xp, mask):
        xu, xr, xc = torch.chunk(xt, 3, dim=-1)
        hz = h @ w_uz
        u = torch.sigmoid(xu + hz[:, :H])
        r = torch.sigmoid(xr + hz[:, H:])
        c = torch.tanh(xc + (r * h) @ w_c)
        h_new = (u * h + (1 - u) * c) if origin_mode \
            else ((1 - u) * h + u * c)
        if m is not None:
            h_new = m * h_new + (1 - m) * h
            outs.append(h_new * m)
        else:
            outs.append(h_new)
        h = h_new
    out = torch.stack(outs, dim=1)
    if reverse:
        out = torch.flip(out, dims=[1])
    return out, h


def dynamic_gru(input, w_hh, bias=None, h0=None, lengths=None,
                is_reverse=False, origin_mode=False, name=None):
    """fluid.layers.dynamic_gru parity (ref: operators/gru_op.cc): input
    projected [B,T,3H]."""
    return gru(input, None, w_hh, b=bias, h0=h0, lengths=lengths,
               reverse=is_reverse, origin_mode=origin_mode)


def simple_rnn(x, w_ih, w_hh, b=None, h0=None, lengths=None, act=torch.tanh):
    """Vanilla RNN (the StaticRNN building block, ref: layers/
    control_flow.py StaticRNN:280). Returns (outputs [B,T,H], h_T)."""
    B, T, D = x.shape
    H = w_hh.shape[0]
    h = h0 if h0 is not None else x.new_zeros((B, H))
    mask = _mask_from_lengths(lengths, T, x.device)
    xp = _project(x, w_ih, b, H)
    outs = []
    for xt, m in _steps(xp, mask):
        h_new = act(xt + h @ w_hh)
        if m is not None:
            h_new = m * h_new + (1 - m) * h
            outs.append(h_new * m)
        else:
            outs.append(h_new)
        h = h_new
    return torch.stack(outs, dim=1), h


def bidirectional_lstm(x, fwd_w_ih, fwd_w_hh, bwd_w_ih, bwd_w_hh,
                       fwd_b=None, bwd_b=None, lengths=None):
    """The forward and the reverse LSTM's outputs side by side (the
    cudnn_lstm bidirectional mode, ref: operators/cudnn_lstm_op.cu.cc)."""
    f, _ = lstm(x, fwd_w_ih, fwd_w_hh, b=fwd_b, lengths=lengths)
    b, _ = lstm(x, bwd_w_ih, bwd_w_hh, b=bwd_b, lengths=lengths,
                reverse=True)
    return torch.cat([f, b], dim=-1)


def attention_lstm(x, c0, attn_w, lstm_w, attn_b=None, lstm_b=None,
                   h0=None, lengths=None):
    """Fused attention + LSTM (ref: operators/attention_lstm_op.cc): at
    each step additive attention scores every source position against the
    previous cell state, ``e_j = tanh(x_j . w_x + c . w_c + b)``, and the
    attention-weighted context feeds one LSTM step. x [B,T,M]; c0 [B,D];
    attn_w [M+D,1]; lstm_w [M+D,4D] over concat(context, h), gate order
    i,f,c,o. The step-invariant ``x @ attn_w[:M]`` is hoisted out of the
    loop; the softmax runs in fp32 with padded positions at -1e9. Returns
    (hidden [B,T,D], (h_T, c_T)); ``lengths`` masks the softmax and freezes
    each row's (h, c) past its end with zero output."""
    B, T, M = x.shape
    D = c0.shape[-1]
    dt = x.dtype
    h = h0 if h0 is not None else x.new_zeros((B, D))
    c = c0.to(dt)
    neg = torch.tensor(-1e9, dtype=torch.float32, device=x.device)
    lengths = (None if lengths is None
               else torch.as_tensor(lengths, device=x.device))
    amask = (None if lengths is None
             else torch.arange(T, device=x.device)[None, :]
             < lengths[:, None])
    x_score = (x @ attn_w[:M])[..., 0]                     # [B, T]
    if attn_b is not None:
        x_score = x_score + attn_b
    outs = []
    for t in range(T):
        e = torch.tanh(x_score + c @ attn_w[M:])            # [B, T]
        e32 = e.to(torch.float32)
        if amask is not None:
            e32 = torch.where(amask, e32, neg)
        a = torch.softmax(e32, dim=-1).to(dt)
        ctx = torch.einsum("bt,btm->bm", a, x)
        gates = torch.cat([ctx, h], dim=-1) @ lstm_w
        if lstm_b is not None:
            gates = gates + lstm_b
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        if lengths is not None:
            live = (t < lengths)[:, None]
            h_new = torch.where(live, h_new, h)
            c_new = torch.where(live, c_new, c)
            outs.append(torch.where(live, h_new, torch.zeros_like(h_new)))
        else:
            outs.append(h_new)
        h, c = h_new, c_new
    return torch.stack(outs, dim=1), (h, c)
