"""fluid.nets: the port of ``paddle_tpu/nets.py``'s composite helpers,
built from ``paddle_tpu_torch.layers``, so each works where its layers do
(in a Program; ``glu`` and ``scaled_dot_product_attention`` also on
tensors; ``sequence_conv_pool`` on ragged batches in the module context,
as in the JAX package, whose sequence ops run eagerly).
"""

import torch

from paddle_tpu_torch import initializer as I
from paddle_tpu_torch import layers
from paddle_tpu_torch.core.lod import RaggedBatch
from paddle_tpu_torch.ops import sequence as seq_ops

__all__ = [
    "simple_img_conv_pool", "img_conv_group", "sequence_conv_pool", "glu",
    "scaled_dot_product_attention",
]


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, pool_padding=0, pool_type="max",
                         global_pooling=False, conv_stride=1, conv_padding=0,
                         conv_dilation=1, conv_groups=1, param_attr=None,
                         bias_attr=None, act=None, use_cudnn=True):
    """nets.simple_img_conv_pool parity: conv2d (with ``act``), then
    pool2d."""
    conv_out = layers.conv2d(
        input=input, num_filters=num_filters, filter_size=filter_size,
        stride=conv_stride, padding=conv_padding, dilation=conv_dilation,
        groups=conv_groups, param_attr=param_attr, bias_attr=bias_attr,
        act=act, use_cudnn=use_cudnn)
    return layers.pool2d(
        conv_out, pool_size=pool_size, pool_type=pool_type,
        pool_stride=pool_stride, pool_padding=pool_padding,
        global_pooling=global_pooling)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max", use_cudnn=True):
    """nets.img_conv_group parity: per entry of ``conv_num_filter`` a
    conv2d, with batch norm (taking ``conv_act``) and dropout where its
    rate is above 1e-5; then one pool2d."""
    tmp = input
    if not hasattr(conv_num_filter, "__len__"):
        conv_num_filter = [conv_num_filter]

    def _expand(v):
        return v if hasattr(v, "__len__") else [v] * len(conv_num_filter)

    padding = _expand(conv_padding)
    fsize = _expand(conv_filter_size)
    with_bn = _expand(conv_with_batchnorm)
    drop = _expand(conv_batchnorm_drop_rate)
    pattr = param_attr if isinstance(param_attr, (list, tuple)) \
        else [param_attr] * len(conv_num_filter)

    for i, nf in enumerate(conv_num_filter):
        local_act = conv_act if not with_bn[i] else None
        tmp = layers.conv2d(
            input=tmp, num_filters=nf, filter_size=fsize[i],
            padding=padding[i], param_attr=pattr[i],
            act=local_act, use_cudnn=use_cudnn)
        if with_bn[i]:
            tmp = layers.batch_norm(input=tmp, act=conv_act)
            if abs(drop[i]) > 1e-5:
                tmp = layers.dropout(x=tmp, dropout_prob=drop[i])

    return layers.pool2d(tmp, pool_size=pool_size, pool_type=pool_type,
                         pool_stride=pool_stride)


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act="sigmoid", pool_type="max", bias_attr=None):
    """nets.sequence_conv_pool parity: a context convolution (an im2col
    weight ``seqconv_w`` [filter_size * H, num_filters] and a bias
    ``seqconv_b``), ``act``, then a sequence pool. ``input``: RaggedBatch
    or (data [B, T, H], lengths). The bias and the activation reach the
    padded steps too, and the pool masks them, as in the JAX package."""
    data = input.data if isinstance(input, RaggedBatch) else input[0]
    h = int(data.shape[-1])
    w = layers._make_param("seqconv_w", (filter_size * h, num_filters),
                           torch.float32, param_attr, I.Xavier())
    conv_out = seq_ops.sequence_conv(input, w, filter_size)
    if bias_attr is not False:
        b = layers._make_param("seqconv_b", (num_filters,), torch.float32,
                               bias_attr, I.Constant(0.0))
        conv_out = RaggedBatch(conv_out.data + b, conv_out.lengths)
    conv_out = RaggedBatch(layers._apply_act(conv_out.data, act),
                           conv_out.lengths)
    return seq_ops.sequence_pool(conv_out, pool_type=pool_type)


def glu(input, dim=-1):
    """nets.glu parity: a, b = split(x, 2, dim); a * sigmoid(b)."""
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    return layers.elementwise_mul(a, layers.sigmoid(b))


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """nets.scaled_dot_product_attention parity on tensors: [B, T, D]
    queries, keys and values split into ``num_heads`` heads, softmax(q k^T
    / sqrt(d_head)) v, heads merged back: [B, Tq, Dv]. The weights take
    ``layers.dropout`` at ``dropout_rate`` (the device's default
    generator)."""
    q, k, v = (torch.as_tensor(x) for x in (queries, keys, values))
    b, tq, d = q.shape
    dv = v.shape[-1]
    if d % num_heads or dv % num_heads:
        raise ValueError("hidden size must divide num_heads")

    def split_heads(x):
        bb, tt, dd = x.shape
        return x.reshape(bb, tt, num_heads, dd // num_heads).permute(
            0, 2, 1, 3)

    qh, kh, vh = split_heads(q), split_heads(k), split_heads(v)
    scale = (d // num_heads) ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * scale
    weights = layers.softmax(logits)
    if dropout_rate:
        weights = layers.dropout(weights, dropout_prob=dropout_rate)
    ctx = torch.einsum("bhqk,bhkd->bhqd", weights, vh)
    return ctx.permute(0, 2, 1, 3).reshape(b, tq, dv)
