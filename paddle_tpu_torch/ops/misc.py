"""Long-tail ops from the reference's root operator directory: the port of
``paddle_tpu/ops/misc.py``, every public function.

Parity targets (each function names its reference file):
add_position_encoding, affine_grid, grid_sampler, bilinear_tensor_product,
conv_shift, row_conv, im2sequence, similarity_focus, spectral_norm, spp,
temporal_shift, pool_with_index / unpool, squared_l2_distance, fsp, hash,
cvm, tree_conv, nce, hierarchical_sigmoid, sample_logits, gru_unit,
lstm_unit, the deformable convolution and pooling, average_accumulates,
beam_search, conv_fusion, and the aliases (sum, top_k, arg_max, ...).
Layouts are NCHW, as in the rest of the op library. Plain PyTorch: no
Pallas body bounds any of them; ``lookup_table`` is ``ops/nn.embedding``,
which launches the embedding gather on the card.

Where the JAX arithmetic has a trap the port keeps it:

- ``top_k`` and ``beam_search`` take ``lax.top_k``'s order (the lower
  index first among ties) from a stable descending sort;
- ``max_pool2d_with_index`` pads with ``finfo.min``, takes the first
  element of a window among ties and returns int32 indices in the unpadded
  image's coordinates; ``unpool2d`` adds colliding values (``.at[].add``);
- ``grid_sampler`` and the deformable ops sample bilinearly from four
  ``floor``-based gathers, so the coordinates get gradients only through
  the bilinear weights;
- ``hash_embedding_ids`` is uint32 fmix arithmetic, computed in int64
  masked to 32 bits after every multiply, with int32 output;
- ``spectral_norm`` with ``u=None`` draws ``u`` from a torch generator
  seeded 0, where the JAX op draws from ``PRNGKey(0)``: the power
  iteration converges to the same sigma, the first iterates differ.
"""

import builtins

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.dtypes import dtype_name
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.ops.tensor_ops import _device

__all__ = [
    "add_position_encoding", "affine_grid", "grid_sampler",
    "bilinear_tensor_product", "conv_shift", "row_conv", "im2sequence",
    "similarity_focus", "spectral_norm", "spp", "temporal_shift",
    "max_pool2d_with_index", "unpool2d", "squared_l2_distance",
    "fsp_matrix", "hash_embedding_ids", "cvm", "tree_conv", "nce",
    "hierarchical_sigmoid", "sample_logits", "gru_unit", "lstm_unit",
    "sum", "top_k", "arg_max", "arg_min", "fill_any_like",
    "fill_zeros_like", "assign_value", "smooth_l1_loss", "lookup_table",
    "deformable_conv", "average_accumulates", "beam_search",
    "conv2d_fusion", "deformable_psroi_pooling", "deformable_roi_pooling",
]

_U32 = 0xFFFFFFFF


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def add_position_encoding(x, alpha=1.0, beta=1.0):
    """operators/add_position_encoding_op.cc: out = alpha*x + beta*PE, PE
    the sin half then the cos half (not interleaved) of pos / 10000^(2i/C),
    computed in x's dtype. x: [B, T, C] (C even)."""
    b, t, c = x.shape
    enforce(c % 2 == 0, "channels must be even")
    pos = torch.arange(t, dtype=x.dtype, device=x.device)[:, None]
    div = torch.pow(torch.tensor(10000.0, dtype=x.dtype, device=x.device),
                    torch.arange(c // 2, dtype=x.dtype, device=x.device)
                    * 2.0 / c)
    ang = pos / div
    pe = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    return alpha * x + beta * pe[None]


def affine_grid(theta, out_shape):
    """operators/affine_grid_op.cc: a 2-D sampling grid from a batch of 2x3
    affine matrices. theta [N, 2, 3], out_shape (N, C, H, W) -> [N, H, W,
    2] of (x, y) in [-1, 1] (align-corners) source coordinates."""
    n, _, h, w = out_shape
    ys = torch.linspace(-1.0, 1.0, h, device=theta.device)
    xs = torch.linspace(-1.0, 1.0, w, device=theta.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1).reshape(
        1, h * w, 3).expand(n, h * w, 3).to(theta.dtype)
    return torch.einsum("nij,npj->npi", theta, base).reshape(n, h, w, 2)


def _bilinear(img, ys, xs, h, w):
    """Bilinear samples of ``img`` [N, C, H*W] at float coordinates ys, xs
    [N, *S] with zero padding outside: four floor-based gathers (the JAX
    ops' arithmetic). Returns [N, C, *S]."""
    n, c = img.shape[:2]
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy, wx = ys - y0, xs - x0
    out = 0.0
    for dy, dx, wgt in ((0, 0, (1 - wy) * (1 - wx)), (0, 1, (1 - wy) * wx),
                        (1, 0, wy * (1 - wx)), (1, 1, wy * wx)):
        yi, xi = y0 + dy, x0 + dx
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        flat = (torch.clamp(yi, 0, h - 1) * w
                + torch.clamp(xi, 0, w - 1)).long().reshape(n, 1, -1)
        g = torch.gather(img, 2, flat.expand(n, c, flat.shape[-1]))
        g = g.reshape((n, c) + tuple(ys.shape[1:]))
        out = out + g * (wgt * valid.to(img.dtype)).unsqueeze(1)
    return out


def grid_sampler(x, grid):
    """operators/grid_sampler_op.cc: bilinear samples of NCHW ``x`` at
    ``grid`` [N, H, W, 2] of (x, y) in [-1, 1], align-corners coordinates
    ``(g + 1)(size - 1)/2``, zero padding outside."""
    n, c, h, w = x.shape
    gx = (grid[..., 0] + 1.0) * (w - 1) / 2.0
    gy = (grid[..., 1] + 1.0) * (h - 1) / 2.0
    return _bilinear(x.reshape(n, c, h * w), gy, gx, h, w)


def bilinear_tensor_product(x, y, weight, bias=None):
    """operators/bilinear_tensor_product_op.cc: out[:, k] = x W[k] y^T
    per row. x [B, M], y [B, N], W [K, M, N]."""
    out = torch.einsum("bm,kmn,bn->bk", x, weight, y)
    if bias is not None:
        out = out + bias
    return out


def conv_shift(x, y):
    """operators/conv_shift_op.cc: circular convolution. x [B, M], y [B, N]
    (N odd, N <= M): out[i] = sum_j x[(i + j - N//2) mod M] * y[j]."""
    m, n = x.shape[1], y.shape[1]
    idx = (torch.arange(m, device=x.device)[:, None]
           + torch.arange(n, device=x.device)[None] - n // 2) % m
    return torch.einsum("bmn,bn->bm", x[:, idx], y)


def row_conv(x, weight):
    """operators/row_conv_op.cc (lookahead conv): x [B, T, D], weight
    [future_ctx, D]: out[t] = sum_k x[t + k] * w[k]."""
    ctx = weight.shape[0]
    t = x.shape[1]
    pad = F.pad(x, (0, 0, 0, ctx - 1))
    idx = (torch.arange(t, device=x.device)[:, None]
           + torch.arange(ctx, device=x.device)[None])
    return torch.einsum("btkd,kd->btd", pad[:, idx], weight)


def im2sequence(x, filter_size, stride=1, padding=0):
    """operators/im2sequence_op.cc: NCHW image -> the sequence of its
    flattened patches [B, oh*ow, C*kh*kw] in (c, kh, kw) order (dense;
    the reference emits LoD)."""
    patches = F.unfold(x, _pair(filter_size), stride=_pair(stride),
                       padding=_pair(padding))
    return patches.transpose(1, 2)


def similarity_focus(x, axis, indexes):
    """operators/similarity_focus_op.cc: for each selected index along
    ``axis``, mark the first argmax position of every row of the other two
    dims; out is a 0/1 mask of x's shape."""
    enforce(x.dim() == 4 and axis in (1, 2, 3), "4-D input, axis in 1..3")
    mask = torch.zeros_like(x)
    for ind in indexes:
        sl = torch.narrow(x, axis, ind, 1)
        for red in range(1, 4):
            if red == axis:
                continue
            am = torch.argmax(sl, dim=red, keepdim=True)
            hit = torch.arange(x.shape[red], device=x.device).reshape(
                [-1 if i == red else 1 for i in range(4)]) == am
            mask = torch.maximum(mask, hit.expand(x.shape).to(x.dtype))
    return mask


def spectral_norm(weight, u=None, power_iters=1, eps=1e-12, dim=0):
    """operators/spectral_norm_op.cc: W / sigma(W) by power iteration.
    Returns (normalized weight, new u). ``u=None`` draws u from a torch
    generator seeded 0 (the JAX op: ``PRNGKey(0)``; the module docstring)."""
    w = torch.movedim(weight, dim, 0)
    h = w.shape[0]
    mat = w.reshape(h, -1)
    if u is None:
        gen = None if mat.device.type == "meta" else torch.Generator(
            device=mat.device).manual_seed(0)
        u = torch.randn(h, generator=gen, dtype=mat.dtype,
                        device=mat.device)
    v = None
    for _ in range(max(power_iters, 1)):
        v = mat.T @ u
        v = v / (torch.linalg.vector_norm(v) + eps)
        u = mat @ v
        u = u / (torch.linalg.vector_norm(u) + eps)
    sigma = u @ mat @ v
    return weight / sigma, u


def spp(x, pyramid_height=3, pool_type="max"):
    """operators/spp_op.cc: spatial pyramid pooling NCHW -> [N, C *
    sum(4^l)]; level l pools 2^l x 2^l cells over floor(i * size / bins),
    each at least one element wide. Max ties split the gradient evenly
    (``amax``, as ``jnp.max``)."""
    n, c, h, w = x.shape
    outs = []
    for lvl in range(pyramid_height):
        bins = 2 ** lvl
        ys = [int(np.floor(i * h / bins)) for i in range(bins + 1)]
        xs = [int(np.floor(i * w / bins)) for i in range(bins + 1)]
        cells = []
        for i in range(bins):
            for j in range(bins):
                cell = x[:, :, ys[i]:builtins.max(ys[i + 1], ys[i] + 1),
                         xs[j]:builtins.max(xs[j + 1], xs[j] + 1)]
                cells.append(cell.amax(dim=(2, 3)) if pool_type == "max"
                             else cell.mean(dim=(2, 3)))
        outs.append(torch.stack(cells, dim=-1).reshape(n, -1))
    return torch.cat(outs, dim=1)


def temporal_shift(x, seg_num, shift_ratio=0.25):
    """operators/temporal_shift_op.cc: shift a quarter of the channels
    back and a quarter forward along time. x [N*T, C, H, W]."""
    nt, c, h, w = x.shape
    xr = x.reshape(nt // seg_num, seg_num, c, h, w)
    c1, c2 = int(c * shift_ratio), int(c * 2 * shift_ratio)
    back = torch.cat([xr[:, 1:, :c1], torch.zeros_like(xr[:, :1, :c1])],
                     dim=1)
    fwd = torch.cat([torch.zeros_like(xr[:, :1, c1:c2]),
                     xr[:, :-1, c1:c2]], dim=1)
    return torch.cat([back, fwd, xr[:, :, c2:]], dim=2).reshape(nt, c, h, w)


def max_pool2d_with_index(x, pool_size, stride=None, padding=0):
    """operators/pool_with_index_op.cc: max pool and the flat argmax
    indices (for unpool), NCHW. The padding is ``finfo.min``; among ties
    the first element of the window in row-major order wins; indices are
    int32 in the unpadded image's coordinates. Written with ``unfold`` and
    ``argmax`` (``F.max_pool2d(return_indices=True)`` pads with -inf and
    breaks ties otherwise)."""
    k = _pair(pool_size)
    s = k if stride is None else _pair(stride)
    p = _pair(padding)
    n, c, h, w = x.shape
    xp = F.pad(x, (p[1], p[1], p[0], p[0]),
               value=float(torch.finfo(x.dtype).min))
    oh = (xp.shape[2] - k[0]) // s[0] + 1
    ow = (xp.shape[3] - k[1]) // s[1] + 1
    patches = F.unfold(xp, k, stride=s).reshape(n, c, k[0] * k[1], oh, ow)
    am = torch.argmax(patches, dim=2, keepdim=True)
    out = torch.gather(patches, 2, am)[:, :, 0]
    am = am[:, :, 0]
    row = (torch.arange(oh, device=x.device)[:, None] * s[0]
           + torch.div(am, k[1], rounding_mode="floor"))
    col = (torch.arange(ow, device=x.device)[None] * s[1] + am % k[1])
    return out, ((row - p[0]) * w + (col - p[1])).to(torch.int32)


def unpool2d(x, indices, out_hw):
    """operators/unpool_op.cc: scatter the pooled values back to their
    argmax positions, zeros elsewhere; values landing on one position add
    (the JAX ``.at[].add``), where ``F.max_unpool2d`` writes one of them."""
    n, c = x.shape[:2]
    oh, ow = out_hw
    flat = torch.zeros((n, c, oh * ow), dtype=x.dtype, device=x.device)
    flat = flat.scatter_add(2, indices.reshape(n, c, -1).long(),
                            x.reshape(n, c, -1))
    return flat.reshape(n, c, oh, ow)


def squared_l2_distance(x, y):
    """operators/squared_l2_distance_op.cc: rowwise ||x - y||^2, [N, 1]."""
    d = (x - y).reshape(x.shape[0], -1)
    return torch.sum(d * d, dim=1, keepdim=True)


def fsp_matrix(a, b):
    """operators/fsp_op.cc (NCHW): the [N, Ca, Cb] Gram matrix over the
    spatial positions, divided by their count."""
    n, ca, h, w = a.shape
    return torch.einsum("ncs,nds->ncd", a.reshape(n, ca, h * w),
                        b.reshape(n, b.shape[1], h * w)) / (h * w)


def hash_embedding_ids(ids, mod, num_hash=1):
    """operators/hash_op.cc: the JAX package's fmix remap of ids into [0,
    mod), bit for bit: uint32 arithmetic (a negative id wraps modulo
    2^32), computed in int64 with every product masked to 32 bits; int32
    out (the JAX package runs with x64 off). As there, a hash seed whose
    ``seed * 0x9E3779B9`` passes 2^32 (num_hash >= 3) raises
    OverflowError."""
    x = torch.as_tensor(ids).to(torch.int64) & _U32
    outs = []
    for seed in range(num_hash):
        mult = seed * 0x9E3779B9
        if mult > _U32:
            raise OverflowError(
                f"Python integer {mult} out of bounds for uint32")
        h = x ^ mult
        h = ((h ^ (h >> 16)) * 0x85EBCA6B) & _U32
        h = ((h ^ (h >> 13)) * 0xC2B2AE35) & _U32
        h = h ^ (h >> 16)
        outs.append((h % mod).to(torch.int32))
    return outs[0] if num_hash == 1 else torch.stack(outs, dim=-1)


def cvm(x, use_cvm=True):
    """operators/cvm_op.cc: the CTR show/click columns. With use_cvm the
    first two become log(show + 1) and log(click + 1) - log(show + 1);
    without, they are dropped."""
    show = torch.log(x[:, :1] + 1.0)
    click = torch.log(x[:, 1:2] + 1.0) - show
    if use_cvm:
        return torch.cat([show, click, x[:, 2:]], dim=1)
    return x[:, 2:]


def tree_conv(nodes, edges, weight, max_depth=2):
    """operators/tree_conv_op.cc as the JAX op simplifies it: nodes [B, N,
    D], edges [B, N, N] 0/1 adjacency, weight [K, D, O] of K hops: out =
    sum_k A^k nodes W_k."""
    out = 0.0
    a = torch.eye(nodes.shape[1], dtype=nodes.dtype,
                  device=nodes.device)[None].expand(edges.shape)
    for k in range(builtins.min(weight.shape[0], max_depth + 1)):
        out = out + torch.einsum("bnm,bmd,do->bno", a, nodes, weight[k])
        a = torch.einsum("bnm,bmk->bnk", a, edges)
    return out


def nce(x, weight, bias, labels, sample_ids, num_total_classes):
    """operators/nce_op.cc: noise-contrastive estimation with the uniform
    noise distribution. x [B, D], weight [C, D], labels [B], sample_ids
    [S] negative class ids. Returns [B]."""
    labels, sample_ids = labels.long(), sample_ids.long()
    q = 1.0 / num_total_classes
    s = sample_ids.shape[0]
    shift = float(np.log(s * q))
    pos_logit = torch.einsum("bd,bd->b", x, weight[labels]) + bias[labels]
    neg_logit = x @ weight[sample_ids].T + bias[sample_ids]
    pos = F.logsigmoid(pos_logit - shift)
    neg = F.logsigmoid(-(neg_logit - shift))
    return -(pos + neg.sum(dim=1)) / (1 + s)


def hierarchical_sigmoid(x, weight, bias, labels, num_classes):
    """operators/hierarchical_sigmoid_op.cc over the default complete
    binary tree (heap numbering, leaves num_classes..2*num_classes-1,
    internal node k storing weight[k-1]): loss[b] = sum over the leaf to
    root walk of softplus((1 - 2*code) * (w . x_b + b)), steps past the
    root masked."""
    depth = int(np.ceil(np.log2(2 * builtins.max(num_classes, 2))))
    node = labels.to(torch.int64) + num_classes
    loss = 0.0
    for _ in range(depth):
        active = node > 1
        code = node % 2
        parent = torch.div(node, 2, rounding_mode="floor")
        nid = torch.clamp(parent - 1, min=0)
        logit = torch.einsum("bd,bd->b", x, weight[nid]) + bias[nid]
        sign = 1.0 - 2.0 * code.to(x.dtype)
        sp = torch.logaddexp(sign * logit, torch.zeros_like(logit))
        loss = loss + active.to(x.dtype) * sp
        node = torch.where(active, parent, node)
    return loss


def sample_logits(logits, labels, sample_ids):
    """operators/sample_logits_op.cc: the label logit then the sampled
    classes' logits, [B, 1 + S], and the new labels (all 0, int32)."""
    pos = torch.gather(logits, 1, labels.long()[:, None])
    neg = logits[:, sample_ids.long()]
    return torch.cat([pos, neg], dim=1), torch.zeros(
        logits.shape[0], dtype=torch.int32, device=logits.device)


def gru_unit(x, h_prev, w_gates, w_cand, b_gates=None, b_cand=None):
    """operators/gru_unit_op.cc: one GRU step in origin mode, u*h + (1 -
    u)*c. x [B, 3H] pre-projected, h_prev [B, H], w_gates [H, 2H], w_cand
    [H, H]."""
    hdim = h_prev.shape[1]
    gi = x[:, :2 * hdim] + h_prev @ w_gates
    if b_gates is not None:
        gi = gi + b_gates
    u, r = torch.chunk(torch.sigmoid(gi), 2, dim=1)
    c = x[:, 2 * hdim:] + (r * h_prev) @ w_cand
    if b_cand is not None:
        c = c + b_cand
    c = torch.tanh(c)
    return u * h_prev + (1 - u) * c


def lstm_unit(x, h_prev, c_prev):
    """operators/lstm_unit_op.cc: one LSTM step from pre-projected x [B,
    4H] in gate order i, f, c, o; returns (h, c)."""
    i, f, g, o = torch.chunk(x, 4, dim=1)
    c = torch.sigmoid(f) * c_prev + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


# aliases of reference op names whose function exists under another name
def sum(xs):                                     # noqa: A001
    """operators/sum_op.cc: the elementwise sum of a list of tensors."""
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


def _top_k(x, k):
    """``lax.top_k``: the k largest along the last axis, descending, the
    lower index first among ties (a stable sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def top_k(x, k):
    """operators/top_k_op.cc: (values, int32 indices), ``lax.top_k``'s
    order."""
    vals, idx = _top_k(x, k)
    return vals, idx.to(torch.int32)


def arg_max(x, axis=-1):
    """The first max's index along ``axis``, int32: ``jnp.argmax``'s
    default integer with x64 off (``tensor_ops.argmax`` asks for int64)."""
    return torch.argmax(x, dim=axis).to(torch.int32)


def arg_min(x, axis=-1):
    """The first min's index along ``axis``, int32 (as :func:`arg_max`)."""
    return torch.argmin(x, dim=axis).to(torch.int32)


def fill_any_like(x, value):
    return torch.full_like(x, value)


def fill_zeros_like(x):
    return torch.zeros_like(x)


def assign_value(shape, dtype, values, device=None):
    """``values`` as a tensor of ``shape`` and ``dtype``, through numpy as
    in the JAX op; on ``device`` (None: the card, or a CPU constant while a
    Program is being built)."""
    if isinstance(dtype, torch.dtype):
        dtype = dtype_name(dtype)
    return torch.as_tensor(np.asarray(values, dtype).reshape(shape),
                           device=_device(device))


def smooth_l1_loss(x, y, sigma=1.0):
    from paddle_tpu_torch.ops.loss import smooth_l1
    return smooth_l1(x, y, sigma=sigma)


def lookup_table(ids, table, padding_idx=None):
    """operators/lookup_table_op.cc: ``ops/nn.embedding`` itself (the
    embedding gather on the card)."""
    from paddle_tpu_torch.ops.nn import embedding
    return embedding(ids, table, padding_idx=padding_idx)


def deformable_conv(x, offset, weight, stride=1, padding=0,
                    deformable_groups=1, mask=None):
    """operators/deformable_conv_op.cc (v1; v2, modulated, with ``mask``).
    x [N, Cin, H, W], offset [N, 2*dg*kh*kw, Ho, Wo] in (dy, dx)
    interleave, weight [Cout, Cin, kh, kw]: bilinear samples at every
    offset tap (all groups and taps in one gather), then one matmul over
    the columns flattened channel-major, ((g*cg + c)*K + k)."""
    s, p = _pair(stride), _pair(padding)
    n, cin, h, w = x.shape
    cout, _, kh, kw = weight.shape
    kk, dg = kh * kw, deformable_groups
    oh = (h + 2 * p[0] - kh) // s[0] + 1
    ow = (w + 2 * p[1] - kw) // s[1] + 1
    enforce(offset.shape[1] == 2 * dg * kk, "offset channel mismatch")
    off = offset.reshape(n, dg, kk, 2, oh, ow)
    dev, dt = x.device, x.dtype
    taps = torch.arange(kk, device=dev)
    ky = torch.div(taps, kw, rounding_mode="floor").to(dt)
    kx = (taps % kw).to(dt)
    base_y = (torch.arange(oh, device=dev) * s[0] - p[0]).to(dt)
    base_x = (torch.arange(ow, device=dev) * s[1] - p[1]).to(dt)
    py = base_y[:, None] + ky[:, None, None] + off[:, :, :, 0]
    px = base_x[None] + kx[:, None, None] + off[:, :, :, 1]
    cg = cin // dg
    # [N*dg, cg, H*W] sampled at [N*dg, K, Ho, Wo]
    col = _bilinear(x.reshape(n * dg, cg, h * w),
                    py.reshape(n * dg, kk, oh, ow),
                    px.reshape(n * dg, kk, oh, ow), h, w)
    if mask is not None:
        col = col * mask.reshape(n * dg, 1, kk, oh, ow)
    col = col.reshape(n, cin * kk, oh, ow)
    return torch.einsum("ok,nkhw->nohw", weight.reshape(cout, cin * kk), col)


def average_accumulates(param, sum_1, sum_2, sum_3, num_accumulates,
                        old_num_accumulates, num_updates,
                        average_window=10000, max_average_window=10000,
                        min_average_window=10000):
    """operators/average_accumulates_op.cc: the ModelAverage optimizer's
    rolling accumulator update (sum_1 the current window, sum_2 the
    previous windows, sum_3 the overflow staging), with the JAX op's shift,
    overflow and counter arithmetic. Returns the six new values."""
    def t(v):
        return torch.as_tensor(v, device=param.device)
    num_updates = t(num_updates) + 1
    num_accumulates = t(num_accumulates) + 1
    old_num_accumulates = t(old_num_accumulates)
    sum_1 = sum_1 + param
    do_shift = (num_updates % average_window == 0) | (
        num_accumulates >= max_average_window)
    sum_2_n = torch.where(do_shift, sum_2 + sum_1, sum_2)
    sum_1_n = torch.where(do_shift, torch.zeros_like(sum_1), sum_1)
    old_n = torch.where(do_shift, old_num_accumulates + num_accumulates,
                        old_num_accumulates)
    num_acc_n = torch.where(do_shift, torch.zeros_like(num_accumulates),
                            num_accumulates)
    overflow = old_n > max_average_window
    sum_3_n = torch.where(overflow, sum_2_n, sum_3)
    sum_2_f = torch.where(overflow, torch.zeros_like(sum_2_n), sum_2_n)
    old_f = torch.where(overflow, num_acc_n, old_n)
    return sum_1_n, sum_2_f, sum_3_n, num_acc_n, old_f, num_updates


def beam_search(log_probs, pre_scores, pre_ids, beam_size,
                end_token=None, length_penalty=0.0, step=1):
    """operators/beam_search_op.cc as a batched functional step:
    log_probs [B*beam, V], pre_scores [B*beam], pre_ids [B*beam, L].
    Returns (ids [B*beam, L+1], scores [B*beam], int32 parent [B*beam])
    after the top k over beam*V (``lax.top_k``'s order). A finished beam
    (its prefix ends with end_token) keeps its score and emits end_token
    again."""
    bb, v = log_probs.shape
    b = bb // beam_size
    lp = log_probs
    if end_token is not None:
        done = pre_ids[:, -1] == end_token
        frozen = torch.full_like(lp, -1e9)
        frozen[:, end_token] = 0.0
        lp = torch.where(done[:, None], frozen, lp)
    total = pre_scores[:, None] + lp
    if length_penalty:
        total = total / ((5.0 + step) / 6.0) ** length_penalty
    top_val, top_idx = _top_k(total.reshape(b, beam_size * v), beam_size)
    parent = (torch.div(top_idx, v, rounding_mode="floor")
              + torch.arange(b, device=lp.device)[:, None] * beam_size
              ).reshape(-1)
    token = (top_idx % v).reshape(-1, 1).to(pre_ids.dtype)
    ids = torch.cat([pre_ids[parent], token], dim=1)
    return ids, top_val.reshape(-1), parent.to(torch.int32)


_ACTS = {"sigmoid": torch.sigmoid, "tanh": torch.tanh,
         "gelu": lambda v: F.gelu(v, approximate="tanh"),
         "silu": F.silu, "swish": F.silu, "elu": F.elu,
         "leaky_relu": F.leaky_relu, "softplus": F.softplus,
         "relu6": F.relu6}


def conv2d_fusion(x, weight, bias=None, residual=None, stride=1,
                  padding=0, dilation=1, groups=1, act="relu"):
    """operators/conv_fusion_op.cc: conv, bias, an optional residual add,
    then ``act`` (a ``jax.nn`` name: "relu", "identity" or None, or one of
    ``_ACTS``), one op so fused programs of the reference map one to
    one."""
    out = F.conv2d(x, weight, None, _pair(stride), _pair(padding),
                   _pair(dilation), groups)
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    if residual is not None:
        out = out + residual
    if act == "relu":
        return F.relu(out)
    if act == "identity" or act is None:
        return out
    enforce(act in _ACTS, f"conv2d_fusion: unknown act {act!r}")
    return _ACTS[act](out)


def _hw(v):
    return ((int(v[0]), int(v[1])) if isinstance(v, (list, tuple))
            else (int(v), int(v)))


def deformable_psroi_pooling(x, rois, trans, output_channels, group_size,
                             pooled_size, part_size=None, spatial_scale=1.0,
                             sample_per_part=4, trans_std=0.1,
                             roi_batch_indices=None):
    """operators/deformable_psroi_pooling_op.cc: position-sensitive RoI
    pooling with learned per-part offsets (Deformable R-FCN).

    x [N, C, H, W] with C = output_channels * gh * gw, channel (ctop*gh +
    gi)*gw + gj; rois [R, 5] (batch index, x1, y1, x2, y2) or [R, 4] with
    ``roi_batch_indices``; trans [R, 2, part, part] (dy, dx planes) or None.
    Every RoI, bin and sample at once (one gather of all four bilinear
    corners); out-of-image samples are dropped and each bin divides by its
    count of samples inside. Returns [R, output_channels, kh, kw] fp32."""
    x = x.float()
    rois = rois.float()
    n, c, h, w = x.shape
    kh, kw = _hw(pooled_size)
    gh, gw = _hw(group_size)
    oc = int(output_channels)
    part_h, part_w = (kh, kw) if part_size is None else _hw(part_size)
    sp = int(sample_per_part)
    enforce(c == oc * gh * gw, "channel/group mismatch")
    dev = x.device
    if rois.shape[1] == 5:
        bidx, boxes = rois[:, 0].long(), rois[:, 1:]
    else:
        bidx = (torch.zeros(rois.shape[0], dtype=torch.int64, device=dev)
                if roi_batch_indices is None
                else torch.as_tensor(roi_batch_indices, device=dev).long())
        boxes = rois
    ii, jj = torch.meshgrid(torch.arange(kh, device=dev),
                            torch.arange(kw, device=dev), indexing="ij")
    gi = torch.clamp(torch.div(ii * gh, kh, rounding_mode="floor"), 0,
                     gh - 1)
    gj = torch.clamp(torch.div(jj * gw, kw, rounding_mode="floor"), 0,
                     gw - 1)
    pi = torch.clamp(torch.div(ii * part_h, kh, rounding_mode="floor"), 0,
                     part_h - 1)
    pj = torch.clamp(torch.div(jj * part_w, kw, rounding_mode="floor"), 0,
                     part_w - 1)
    su = (torch.arange(sp, device=dev, dtype=torch.float32) + 0.5) / sp
    x1 = boxes[:, 0] * spatial_scale
    y1 = boxes[:, 1] * spatial_scale
    rw = torch.clamp((boxes[:, 2] - boxes[:, 0]) * spatial_scale, min=0.1)
    rh = torch.clamp((boxes[:, 3] - boxes[:, 1]) * spatial_scale, min=0.1)
    r = boxes.shape[0]
    if trans is not None:
        tr = trans.float().reshape(-1, 2, part_h, part_w)
        dy = tr[:, 0][:, pi, pj] * trans_std * rh[:, None, None]
        dx = tr[:, 1][:, pi, pj] * trans_std * rw[:, None, None]
    else:
        dy = dx = torch.zeros((r, kh, kw), device=dev)
    bin_h = (rh / kh)[:, None, None, None, None]
    bin_w = (rw / kw)[:, None, None, None, None]
    # sample coordinates [R, kh, kw, sp, sp]
    ys = ((y1[:, None, None] + dy)[..., None, None]
          + (ii[..., None, None] + su[None, None, :, None]) * bin_h)
    xs = ((x1[:, None, None] + dx)[..., None, None]
          + (jj[..., None, None] + su[None, None, None, :]) * bin_w)
    inside = (ys >= 0) & (ys <= h - 1) & (xs >= 0) & (xs <= w - 1)
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy, wx = ys - y0, xs - x0
    # flat index of (roi's image, ctop, gi, gj) [R, oc, kh, kw, 1, 1]
    chan = ((torch.arange(oc, device=dev)[:, None, None] * gh + gi) * gw
            + gj)
    plane = ((bidx[:, None, None, None] * c + chan[None]) * (h * w))[
        ..., None, None]
    flat = x.reshape(-1)
    val = 0.0
    for ddy, ddx, wgt in ((0, 0, (1 - wy) * (1 - wx)), (0, 1, (1 - wy) * wx),
                          (1, 0, wy * (1 - wx)), (1, 1, wy * wx)):
        yc = torch.clamp(y0 + ddy, 0, h - 1).long()
        xc = torch.clamp(x0 + ddx, 0, w - 1).long()
        val = val + flat[plane + (yc * w + xc)[:, None]] * wgt[:, None]
    val = val * inside[:, None].to(torch.float32)
    cnt = torch.clamp(inside.sum(dim=(-1, -2)), min=1).to(torch.float32)
    return val.sum(dim=(-1, -2)) / cnt[:, None]


def deformable_roi_pooling(input, rois, trans, no_trans=False,
                           spatial_scale=1.0, group_size=1,
                           pooled_height=1, pooled_width=1, part_size=None,
                           sample_per_part=1, trans_std=0.1,
                           position_sensitive=False, name=None):
    """fluid.layers.deformable_roi_pooling parity over
    :func:`deformable_psroi_pooling`: position_sensitive=False pools each
    input channel (group 1); True is the R-FCN layout."""
    gh, gw = _hw(group_size)
    if position_sensitive:
        oc = input.shape[1] // (gh * gw)
    else:
        gh = gw = 1
        oc = input.shape[1]
    return deformable_psroi_pooling(
        input, rois, None if no_trans else trans, oc, (gh, gw),
        (pooled_height, pooled_width), part_size=part_size,
        spatial_scale=spatial_scale, sample_per_part=sample_per_part,
        trans_std=trans_std)
