"""The standard Layer classes of the eager (dygraph) API: the port of
``paddle_tpu/nn/layers.py`` (Fluid's dygraph/nn.py: Conv2D, Pool2D, FC,
BatchNorm, Embedding, GRUUnit, LayerNorm, NCE, PRelu,
BilinearTensorProduct, Conv2DTranspose, GroupNorm, SpectralNorm, TreeConv,
RowConv, with Linear, Conv3D, Conv3DTranspose, InstanceNorm, Dropout,
LSTMCell and GRUCell).

The parameter keys, shapes and initializers are the JAX package's, so the
JAX ``init``'s dict carries across with ``nn.params_from_numpy`` as it is.
Conv weights are OIHW here (IOHW for the transposed convolutions), as in
the JAX module. The matmuls are ``torch.matmul`` (the JAX package's
``jnp.matmul``, outside any Pallas kernel); ``Embedding`` goes through
``ops.embedding``, so on the card it launches the gather kernel.

The layers that draw (``Dropout``, ``NCE``) draw from the frame's
generator (``current_rng()``), torch's draws, not threefry's. ``NCE``
takes its negatives as an argument too, so that its loss can be held to
the JAX layer's on the same negatives.
"""

import math

import torch

from paddle_tpu_torch import initializer as I
from paddle_tpu_torch import ops
from paddle_tpu_torch.nn.module import (
    Layer, create_parameter, create_state, current_rng, set_state,
)

__all__ = ["Linear", "Conv2D", "Conv2DTranspose", "Conv3D",
           "Conv3DTranspose", "Pool2D", "BatchNorm", "LayerNorm",
           "GroupNorm", "InstanceNorm", "Embedding", "Dropout", "PRelu",
           "GRUUnit", "LSTMCell", "GRUCell", "SpectralNorm", "NCE",
           "BilinearTensorProduct", "FC", "RowConv", "TreeConv"]


def _bias(layer, n):
    return create_parameter("b", (n,), layer.dtype,
                            initializer=I.Constant(0.0),
                            attr=layer.bias_attr)


class Linear(Layer):
    def __init__(self, input_dim, output_dim, param_attr=None,
                 bias_attr=None, act=None, dtype=torch.float32):
        super().__init__("linear")
        self.input_dim, self.output_dim = input_dim, output_dim
        self.param_attr, self.bias_attr = param_attr, bias_attr
        self.act, self.dtype = act, dtype

    def forward(self, x):
        w = create_parameter("w", (self.input_dim, self.output_dim),
                             self.dtype, attr=self.param_attr)
        out = torch.matmul(x, w)
        if self.bias_attr is not False:
            out = out + _bias(self, self.output_dim)
        return ops.fc_act(out, self.act)


class _ConvBase(Layer):
    """The shared constructor of the four convolution layers."""

    _nd = 2

    def __init__(self, scope, num_channels, num_filters, filter_size,
                 stride, padding, dilation, groups, param_attr, bias_attr,
                 act, dtype):
        super().__init__(scope)
        self.num_channels, self.num_filters = num_channels, num_filters
        self.filter_size = filter_size if isinstance(
            filter_size, (tuple, list)) else (filter_size,) * self._nd
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.groups = groups
        self.param_attr, self.bias_attr, self.act = param_attr, bias_attr, act
        self.dtype = dtype

    def _finish(self, out):
        if self.bias_attr is not False:
            b = _bias(self, self.num_filters)
            out = out + b.reshape((1, -1) + (1,) * self._nd)
        return ops.fc_act(out, self.act)

    def _weight(self, lead, init):
        return create_parameter("w", lead + tuple(self.filter_size),
                                self.dtype, initializer=init,
                                attr=self.param_attr)


class Conv2D(_ConvBase):
    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, dilation=1, groups=1, param_attr=None,
                 bias_attr=None, act=None, dtype=torch.float32):
        super().__init__("conv2d", num_channels, num_filters, filter_size,
                         stride, padding, dilation, groups, param_attr,
                         bias_attr, act, dtype)

    def forward(self, x):
        w = self._weight((self.num_filters, self.num_channels // self.groups),
                         I.MSRA(uniform=False))
        return self._finish(ops.conv2d(x, w, self.stride, self.padding,
                                       self.dilation, self.groups))


class Conv2DTranspose(_ConvBase):
    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, dilation=1, groups=1, param_attr=None,
                 bias_attr=None, act=None, dtype=torch.float32):
        super().__init__("conv2d_transpose", num_channels, num_filters,
                         filter_size, stride, padding, dilation, groups,
                         param_attr, bias_attr, act, dtype)

    def forward(self, x):
        w = self._weight((self.num_channels, self.num_filters // self.groups),
                         I.Xavier())
        return self._finish(ops.conv2d_transpose(
            x, w, self.stride, self.padding, self.dilation, self.groups))


class Conv3D(_ConvBase):
    """dygraph/nn.py Conv3D parity (NCDHW)."""

    _nd = 3

    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, dilation=1, groups=1, param_attr=None,
                 bias_attr=None, act=None, dtype=torch.float32):
        super().__init__("conv3d", num_channels, num_filters, filter_size,
                         stride, padding, dilation, groups, param_attr,
                         bias_attr, act, dtype)

    def forward(self, x):
        w = self._weight((self.num_filters, self.num_channels // self.groups),
                         I.MSRA(uniform=False))
        return self._finish(ops.conv3d(x, w, self.stride, self.padding,
                                       self.dilation, self.groups))


class Conv3DTranspose(_ConvBase):
    """dygraph/nn.py Conv3DTranspose parity (IODHW filters)."""

    _nd = 3

    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, dilation=1, groups=1, param_attr=None,
                 bias_attr=None, act=None, dtype=torch.float32):
        super().__init__("conv3d_transpose", num_channels, num_filters,
                         filter_size, stride, padding, dilation, groups,
                         param_attr, bias_attr, act, dtype)

    def forward(self, x):
        w = self._weight((self.num_channels, self.num_filters // self.groups),
                         I.Xavier())
        return self._finish(ops.conv3d_transpose(
            x, w, self.stride, self.padding, self.dilation, self.groups))


class Pool2D(Layer):
    def __init__(self, pool_size=2, pool_type="max", pool_stride=1,
                 pool_padding=0, global_pooling=False, ceil_mode=False,
                 exclusive=True):
        super().__init__("pool2d")
        self.kw = dict(pool_size=pool_size, pool_type=pool_type,
                       pool_stride=pool_stride, pool_padding=pool_padding,
                       global_pooling=global_pooling, ceil_mode=ceil_mode,
                       exclusive=exclusive)

    def forward(self, x):
        return ops.pool2d(x, **self.kw)


class BatchNorm(Layer):
    """Batch norm with its running mean and variance as ``nn`` state
    (``mean`` 0 and ``variance`` 1), overwritten by each training call."""

    def __init__(self, num_channels, act=None, is_test=False, momentum=0.9,
                 epsilon=1e-5, param_attr=None, bias_attr=None,
                 data_layout="NCHW", use_global_stats=False,
                 trainable_statistics=False, dtype=torch.float32):
        super().__init__("batch_norm")
        self.c = num_channels
        self.act, self.is_test = act, is_test
        self.momentum, self.epsilon = momentum, epsilon
        self.param_attr, self.bias_attr = param_attr, bias_attr
        self.data_layout = data_layout
        self.use_global_stats = use_global_stats
        self.dtype = dtype

    def forward(self, x, is_test=None):
        is_test = self.is_test if is_test is None else is_test
        scale = create_parameter("scale", (self.c,), self.dtype,
                                 initializer=I.Constant(1.0),
                                 attr=self.param_attr)
        bias = create_parameter("bias", (self.c,), self.dtype,
                                initializer=I.Constant(0.0),
                                attr=self.bias_attr)
        mean = create_state("mean", (self.c,), self.dtype, 0.0)
        var = create_state("variance", (self.c,), self.dtype, 1.0)
        out, mean_out, var_out, _, _ = ops.batch_norm(
            x, scale, bias, mean, var, self.epsilon, self.momentum,
            is_test=is_test, data_layout=self.data_layout,
            use_global_stats=self.use_global_stats)
        if not is_test:
            set_state("mean", mean_out.detach())
            set_state("variance", var_out.detach())
        return ops.fc_act(out, self.act)


class LayerNorm(Layer):
    def __init__(self, normalized_shape, scale=True, shift=True,
                 epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
                 dtype=torch.float32):
        super().__init__("layer_norm")
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.ns = tuple(normalized_shape)
        self.scale, self.shift = scale, shift
        self.epsilon, self.act, self.dtype = epsilon, act, dtype
        self.param_attr, self.bias_attr = param_attr, bias_attr

    def forward(self, x):
        s = create_parameter("scale", self.ns, self.dtype,
                             initializer=I.Constant(1.0),
                             attr=self.param_attr) if self.scale else None
        b = create_parameter("bias", self.ns, self.dtype,
                             initializer=I.Constant(0.0),
                             attr=self.bias_attr) if self.shift else None
        out = ops.layer_norm(x, s, b, begin_norm_axis=x.dim() - len(self.ns),
                             epsilon=self.epsilon)
        return ops.fc_act(out, self.act)


class GroupNorm(Layer):
    def __init__(self, channels, groups, epsilon=1e-5, param_attr=None,
                 bias_attr=None, act=None, dtype=torch.float32):
        super().__init__("group_norm")
        self.c, self.g, self.epsilon = channels, groups, epsilon
        self.param_attr, self.bias_attr = param_attr, bias_attr
        self.act, self.dtype = act, dtype

    def forward(self, x):
        s = create_parameter("scale", (self.c,), self.dtype,
                             initializer=I.Constant(1.0), attr=self.param_attr)
        b = create_parameter("bias", (self.c,), self.dtype,
                             initializer=I.Constant(0.0), attr=self.bias_attr)
        return ops.fc_act(ops.group_norm(x, s, b, self.g, self.epsilon),
                          self.act)


class InstanceNorm(Layer):
    def __init__(self, channels, epsilon=1e-5, dtype=torch.float32):
        super().__init__("instance_norm")
        self.c, self.epsilon, self.dtype = channels, epsilon, dtype

    def forward(self, x):
        s = create_parameter("scale", (self.c,), self.dtype,
                             initializer=I.Constant(1.0))
        b = create_parameter("bias", (self.c,), self.dtype,
                             initializer=I.Constant(0.0))
        return ops.instance_norm(x, s, b, self.epsilon)


class Embedding(Layer):
    """Rows of the table ``w`` at ``ids`` through ``ops.embedding`` (the
    gather kernel on the card). ``is_sparse`` is advisory, as in the JAX
    package: the gradient is dense."""

    def __init__(self, size, is_sparse=False, padding_idx=None,
                 param_attr=None, dtype=torch.float32):
        super().__init__("embedding")
        self.size = tuple(size)
        self.padding_idx = padding_idx
        self.param_attr, self.dtype = param_attr, dtype
        self.is_sparse = is_sparse

    def forward(self, ids):
        w = create_parameter("w", self.size, self.dtype,
                             initializer=I.Xavier(), attr=self.param_attr)
        return ops.embedding(ids, w, self.padding_idx)


class Dropout(Layer):
    def __init__(self, p=0.5, dropout_implementation="downgrade_in_infer"):
        super().__init__("dropout")
        self.p = p
        self.impl = dropout_implementation

    def forward(self, x, is_test=False):
        if is_test or self.p == 0.0:
            return ops.dropout(x, self.p, is_test=True,
                               dropout_implementation=self.impl)
        return ops.dropout(x, self.p, rng=current_rng(),
                           dropout_implementation=self.impl)


class PRelu(Layer):
    def __init__(self, mode="all", channel=None, input_shape=None,
                 param_attr=None, dtype=torch.float32):
        super().__init__("prelu")
        self.mode, self.channel, self.input_shape = mode, channel, input_shape
        self.param_attr, self.dtype = param_attr, dtype

    def forward(self, x):
        if self.mode == "all":
            shape = (1,)
        elif self.mode == "channel":
            shape = (self.channel or x.shape[1],)
        else:
            shape = tuple(self.input_shape or x.shape[1:])
        a = create_parameter("alpha", shape, self.dtype,
                             initializer=I.Constant(0.25),
                             attr=self.param_attr)
        return ops.prelu(x, a, self.mode)


class GRUUnit(Layer):
    """dygraph/nn.py GRUUnit parity (gru_unit_op.cc's update): ``input``
    is the projected [B, 3 d] gate input, ``hidden`` [B, d]."""

    def __init__(self, size, param_attr=None, bias_attr=None,
                 activation="tanh", gate_activation="sigmoid",
                 origin_mode=False, dtype=torch.float32):
        super().__init__("gru_unit")
        self.hidden = size // 3
        self.param_attr, self.bias_attr = param_attr, bias_attr
        self.activation, self.gate_activation = activation, gate_activation
        self.origin_mode = origin_mode
        self.dtype = dtype

    def forward(self, input, hidden):
        d = self.hidden
        w = create_parameter("w", (d, d * 3), self.dtype,
                             attr=self.param_attr)
        b = _bias(self, d * 3) if self.bias_attr is not False else 0.0
        x = input + b
        xu, xr, xc = x[:, :d], x[:, d:2 * d], x[:, 2 * d:]
        hu, hr = hidden @ w[:, :d], hidden @ w[:, d:2 * d]
        gact = getattr(ops, self.gate_activation)
        act = getattr(ops, self.activation)
        u = gact(xu + hu)
        r = gact(xr + hr)
        c = act(xc + (r * hidden) @ w[:, 2 * d:])
        if self.origin_mode:
            return u * hidden + (1 - u) * c
        return (1 - u) * hidden + u * c


class LSTMCell(Layer):
    """Basic LSTM cell (lstm_unit_op.cc semantics): gates i, f, c, o from
    [input, pre_hidden] @ w + b, ``forget_bias`` on f."""

    def __init__(self, hidden_size, input_size, param_attr=None,
                 bias_attr=None, forget_bias=1.0, dtype=torch.float32):
        super().__init__("lstm_cell")
        self.h, self.i = hidden_size, input_size
        self.param_attr, self.bias_attr = param_attr, bias_attr
        self.forget_bias = forget_bias
        self.dtype = dtype

    def forward(self, input, pre_hidden, pre_cell):
        w = create_parameter("w", (self.i + self.h, 4 * self.h), self.dtype,
                             attr=self.param_attr)
        b = _bias(self, 4 * self.h)
        gates = torch.cat([input, pre_hidden], dim=-1) @ w + b
        i, f, c, o = torch.chunk(gates, 4, dim=-1)
        new_cell = (torch.sigmoid(f + self.forget_bias) * pre_cell
                    + torch.sigmoid(i) * torch.tanh(c))
        return torch.sigmoid(o) * torch.tanh(new_cell), new_cell


class GRUCell(Layer):
    def __init__(self, hidden_size, input_size, dtype=torch.float32):
        super().__init__("gru_cell")
        self.h, self.i, self.dtype = hidden_size, input_size, dtype

    def forward(self, input, pre_hidden):
        wx = create_parameter("wx", (self.i, 3 * self.h), self.dtype)
        wh = create_parameter("wh", (self.h, 3 * self.h), self.dtype)
        b = create_parameter("b", (3 * self.h,), self.dtype,
                             initializer=I.Constant(0.0))
        xu, xr, xc = torch.chunk(input @ wx + b, 3, dim=-1)
        hu, hr, hc = torch.chunk(pre_hidden @ wh, 3, dim=-1)
        u = torch.sigmoid(xu + hu)
        r = torch.sigmoid(xr + hr)
        c = torch.tanh(xc + r * hc)
        return (1 - u) * pre_hidden + u * c


class SpectralNorm(Layer):
    """spectral_norm_op.cc parity by power iteration: ``u`` and ``v`` are
    state (ones at first), stored detached after each call; the
    iteration itself is differentiated, as in the JAX layer."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 dtype=torch.float32):
        super().__init__("spectral_norm")
        self.shape = tuple(weight_shape)
        self.dim, self.power_iters, self.eps = dim, power_iters, eps
        self.dtype = dtype

    def forward(self, weight):
        w = torch.movedim(weight, self.dim, 0).reshape(
            self.shape[self.dim], -1)
        h, wdim = w.shape
        u = create_state("u", (h,), self.dtype, 1.0)
        v = create_state("v", (wdim,), self.dtype, 1.0)
        for _ in range(self.power_iters):
            v = w.T @ u
            v = v / (torch.linalg.vector_norm(v) + self.eps)
            u = w @ v
            u = u / (torch.linalg.vector_norm(u) + self.eps)
        set_state("u", u.detach())
        set_state("v", v.detach())
        return weight / (u @ w @ v)


def nce_loss(input, label, w, b, negatives, num_total_classes):
    """The NCE layer's loss (nce_op.cc with a uniform sampler, the JAX
    layer's formula) over given negatives [B, k]: [B, 1]."""
    label = label.reshape(-1)
    k = negatives.shape[1]
    log_kp = math.log(k * (1.0 / num_total_classes))
    pos_logit = torch.sum(input * w[label], dim=-1) + b[label]
    neg_logit = torch.einsum("bd,bkd->bk", input, w[negatives]) + b[negatives]
    pos_loss = -torch.nn.functional.logsigmoid(pos_logit - log_kp)
    neg_loss = -torch.sum(
        torch.log1p(-torch.sigmoid(neg_logit - log_kp) + 1e-12), dim=-1)
    return (pos_loss + neg_loss)[:, None]


class NCE(Layer):
    """nce_op.cc parity (noise-contrastive estimation, uniform sampler,
    the training loss only). The negatives [B, num_neg_samples] are
    drawn from the frame's generator unless given."""

    def __init__(self, num_total_classes, dim, num_neg_samples=10,
                 param_attr=None, bias_attr=None, dtype=torch.float32):
        super().__init__("nce")
        self.n, self.dim = num_total_classes, dim
        self.k = num_neg_samples
        self.param_attr, self.bias_attr = param_attr, bias_attr
        self.dtype = dtype

    def forward(self, input, label, negatives=None):
        w = create_parameter("w", (self.n, self.dim), self.dtype,
                             attr=self.param_attr)
        b = create_parameter("b", (self.n,), self.dtype,
                             initializer=I.Constant(0.0),
                             attr=self.bias_attr)
        label = torch.as_tensor(label, device=input.device)
        if negatives is None:
            negatives = torch.randint(0, self.n, (input.shape[0], self.k),
                                      generator=current_rng(),
                                      device=input.device)
        return nce_loss(input, label, w, b, negatives, self.n)


class BilinearTensorProduct(Layer):
    """bilinear_tensor_product_op.cc parity: out[b, o] = x[b] W[o] y[b]."""

    def __init__(self, input1_dim, input2_dim, output_dim, param_attr=None,
                 bias_attr=None, act=None, dtype=torch.float32):
        super().__init__("bilinear_tensor_product")
        self.d1, self.d2, self.out = input1_dim, input2_dim, output_dim
        self.param_attr, self.bias_attr, self.act = param_attr, bias_attr, act
        self.dtype = dtype

    def forward(self, x, y):
        w = create_parameter("w", (self.out, self.d1, self.d2), self.dtype,
                             attr=self.param_attr)
        out = torch.einsum("bi,oij,bj->bo", x, w, y)
        if self.bias_attr is not False:
            out = out + _bias(self, self.out)
        return ops.fc_act(out, self.act)


class FC(Layer):
    """fluid.dygraph.FC parity: the dims from ``num_flatten_dims`` on are
    flattened (fc_op.cc), then ``x @ w + b`` and ``act``."""

    def __init__(self, size, num_flatten_dims=1, param_attr=None,
                 bias_attr=None, act=None, dtype=torch.float32):
        super().__init__("fc")
        self.size = size
        self.nfd = num_flatten_dims
        self.param_attr, self.bias_attr = param_attr, bias_attr
        self.act, self.dtype = act, dtype

    def forward(self, x):
        lead = tuple(x.shape[:self.nfd])
        flat = x.reshape(math.prod(lead), -1)
        w = create_parameter("w", (flat.shape[-1], self.size), self.dtype,
                             attr=self.param_attr)
        out = flat @ w
        if self.bias_attr is not False:
            out = out + _bias(self, self.size)
        return ops.fc_act(out.reshape(*lead, self.size), self.act)


class RowConv(Layer):
    """dygraph RowConv (row_conv_op.cc lookahead conv): a [future + 1, D]
    filter."""

    def __init__(self, input_dim, future_context_size, param_attr=None,
                 act=None, dtype=torch.float32):
        super().__init__("row_conv")
        self.d = input_dim
        self.ctx = future_context_size + 1
        self.param_attr, self.act, self.dtype = param_attr, act, dtype

    def forward(self, x):
        w = create_parameter("w", (self.ctx, self.d), self.dtype,
                             attr=self.param_attr)
        return ops.fc_act(ops.row_conv(x, w), self.act)


class TreeConv(Layer):
    """dygraph TreeConv (tree_conv_op.cc): hop-indexed tree convolution
    over (nodes, adjacency), [B, N, output_size, num_filters]."""

    def __init__(self, feature_size, output_size, num_filters=1,
                 max_depth=2, act="tanh", param_attr=None,
                 bias_attr=None, dtype=torch.float32):
        super().__init__("tree_conv")
        self.d, self.out = feature_size, output_size
        self.nf = num_filters
        self.hops = max_depth + 1
        self.max_depth = max_depth
        self.param_attr, self.bias_attr = param_attr, bias_attr
        self.act, self.dtype = act, dtype

    def forward(self, nodes, edges):
        w = create_parameter("w", (self.hops, self.d, self.out * self.nf),
                             self.dtype, attr=self.param_attr)
        out = ops.tree_conv(nodes, edges, w, max_depth=self.max_depth)
        if self.bias_attr is not False:
            out = out + _bias(self, self.out * self.nf)
        out = out.reshape(tuple(out.shape[:-1]) + (self.out, self.nf))
        return ops.fc_act(out, self.act)
