"""fluid.layers: the port of ``paddle_tpu/layers/__init__.py`` for the
static path's ops.

Every function works in both modes, as the JAX package's do:

- **eager**: computes at once through the port's op functions
  (``paddle_tpu_torch/ops``) on the tensors it is given;
- **static** (after ``enable_static()`` or inside ``program_guard``): appends
  an op to the current Program and returns a symbolic Variable. The output's
  shape and dtype come from running the op's plain body on
  ``torch.device("meta")`` tensors, twice, with the dynamic dims set to 2
  and to 3: an output dim that moves between the two probes depends on a
  dynamic input dim and is recorded as -1 (layers/__init__.py:230-258). Meta
  tensors never reach the kernel registry: an op that holds a kernel is
  inferred through its plain body (``_SHAPE_BODIES``).

Every function of the op modules ``activation``, ``math``, ``reduce``,
``tensor_ops``, ``loss``, ``control_flow``, ``tensor_array`` and
``selected_rows`` (its ``SelectedRows`` class too) is wrapped
here as the JAX package wraps every exported op (layers/__init__.py:
340-360), with its table of leading tensor arguments (``_NARGS``; 0 for
the ops that make a tensor from nothing, which therefore compute at once
in a Program too, their value becoming a program constant where a
Variable op uses it). Beside them: ``fc``, ``embedding``, ``softmax``,
the layers of the book CNNs (``conv2d``, ``pool2d``, ``batch_norm``,
``dropout``), the learning-rate schedules (``learning_rate_scheduler``),
the control-flow classes (``While``, ``Switch``, ``IfElse``,
``StaticRNN``, ``DynamicRNN``), ``while_loop`` and ``static_rnn`` (in a
Program: the ``while_block`` and ``scan_block`` ops of
``static/nested.py``) and the reader surface of ``layers/io.py``.

The random ops (``ops/random_ops.py``), the long-tail ops of
``ops/misc.py`` and the CTC ops (``ops/ctc.py``) are wrapped the same way,
with the JAX tables' entries: the four random ops that take only a shape
have ``_NARGS`` 0 (in a Program they draw at once, a constant); the misc
ops that return a tuple give one Variable, the first output
(``_FIRST_OUT``); ``layers.sum`` over a list of Variables raises TypeError,
as the JAX wrapper does.

``dropout``, ``sampled_softmax_with_cross_entropy`` and the random ops are
ops that draw (``_needs_rng``): the Executor hands each a generator on its
device, seeded from the program's ``random_seed``, the run and the op (the
op's own ``seed`` attr is ignored there, as the JAX ``_key`` ignores it
when given a key). ``batch_norm`` in a Program keeps its moving mean and variance
as non-trainable persistable parameters, which its op's ``MeanOut`` and
``VarianceOut`` overwrite; outside a Program (the module context) they
are ``nn`` state (``bn_mean``, ``bn_variance``), as in the JAX package. A
``WeightNormParamAttr`` makes a parameter ``g * v / ||v||`` in both
contexts.

The detection layers: every function of ``ops/detection.py`` but the eight
that take or return lists or run on the host (``_DETECTION_HOST``: eager
passthroughs, as the JAX package exposes them, layers/__init__.py:341-347
and :382-390), the interpolation ops of ``ops/nn.py``, and
``multi_box_head`` (its parameters named as the JAX layer names them). In
a Program ``ssd_loss``'s ``prior_box_var`` and ``yolov3_loss``'s
``gt_score``, given as Variables, ride the op's inputs.

The sequence models' layers: the 17 sequence ops (``sequence_*``), the CRF
(``linear_chain_crf`` with its ``crfw`` parameter, ``crf_decoding``), the
recurrent ops (``lstm``, ``gru``, ``dynamic_lstm``, ``dynamic_lstmp``,
``dynamic_gru``, ``simple_rnn``, ``bidirectional_lstm``,
``attention_lstm``), ``sums`` and ``create_parameter``. A parameterized
layer outside a Program creates its parameters in the module context
(``paddle_tpu_torch.nn``: ``nn.transform``, ``Layer.init``/``apply``) and
computes at once. In a Program, an optional tensor argument given as a
Variable in an attribute position (``dynamic_lstm``'s ``w_hh``, ``bias``
and ``lengths``, ``crf_decoding``'s ``length``) rides the op's inputs, its
parameter names recorded in the ``_tensor_params`` attr, as the JAX
package's ``_append_static`` records them; a list in an attribute position
that holds a Variable (``fake_channel_wise_dequantize_max_abs``'s
``scales``) is flattened into the inputs, its non-Variable members program
constants, and recorded as ``(name, count)`` so that the op regroups it
(paddle_tpu/layers/__init__.py:130, :196-206). The recurrent ops' op yields
one Variable, the outputs (their final state is not an output of the op).

The quantization ops (``ops/quantize.py``) and ``ops/aliases.py`` are
wrapped the same way, with the JAX tables' entries (the quantizers give 2
or 4 Variables); ``delete_var`` and ``alloc_continuous_space`` are plain
passthroughs (the JAX ``_EXCLUDE``). ``layers``' own functions of the JAX
package: ``hsigmoid``, ``hash``, ``continuous_value_model``,
``create_global_var``, ``autoincreased_step_counter`` (a persistable
``@STEP_COUNTER@`` that an ``increment_inplace`` op moves on every run),
``Print`` (the ``print`` op: the identity, logging to stderr) and
``py_func`` (a host op: the Executor calls ``func`` on numpy values; its
outputs carry no gradient), ``register_op_init_param`` and
``OP_REGISTRY``.
"""

import builtins
import contextlib
import functools
import inspect
import math
import sys

import numpy as np
import torch

from paddle_tpu_torch import initializer as I
from paddle_tpu_torch.core.dtypes import convert_dtype, dtype_name
from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.framework import (
    ParamAttr, WeightNormParamAttr, unique_name,
)
from paddle_tpu_torch.layers import learning_rate_scheduler
from paddle_tpu_torch.layers.learning_rate_scheduler import (
    cosine_decay, exponential_decay, inverse_time_decay, linear_lr_warmup,
    natural_exp_decay, noam_decay, piecewise_decay, polynomial_decay,
)
from paddle_tpu_torch.nn import module as _module
from paddle_tpu_torch.ops import activation as _act
from paddle_tpu_torch.ops import aliases as _aliases
from paddle_tpu_torch.ops import control_flow as _cf
from paddle_tpu_torch.ops import crf as _crf
from paddle_tpu_torch.ops import ctc as _ctc
from paddle_tpu_torch.ops import detection as _det
from paddle_tpu_torch.ops import loss as _loss
from paddle_tpu_torch.ops import math as _math
from paddle_tpu_torch.ops import metric_ops as _metric
from paddle_tpu_torch.ops import misc as _misc
from paddle_tpu_torch.ops import nn as _nn
from paddle_tpu_torch.ops import quantize as _quantize
from paddle_tpu_torch.ops import random_ops as _random
from paddle_tpu_torch.ops import reduce as _reduce
from paddle_tpu_torch.ops import rnn as _rnn
from paddle_tpu_torch.ops import selected_rows as _sr
from paddle_tpu_torch.ops import sequence as _seq
from paddle_tpu_torch.ops import tensor_array as _ta
from paddle_tpu_torch.ops import tensor_ops as _tensor
from paddle_tpu_torch.layers.control_flow_classes import (
    DynamicRNN, IfElse, StaticRNN, Switch, While,
)
from paddle_tpu_torch.static.program import (
    OP_REGISTRY, Variable, default_main_program, default_startup_program,
    in_static_mode, data, register_op,
)

#: the op modules whose every function ``layers`` wraps (the JAX package
#: wraps every exported op, layers/__init__.py:340-360)
_WRAPPED = (_act, _math, _reduce, _tensor, _loss, _cf, _ta, _sr, _random,
            _misc, _ctc, _quantize, _aliases)
#: the functions of the wrapped modules that take a scope or return a list:
#: eager passthroughs, with no op (the JAX package's ``_EXCLUDE``)
_PASSTHROUGH = ("delete_var", "alloc_continuous_space")
#: the detection functions that run on the host or take lists: eager
#: passthroughs, with no op (the JAX package's ``_EXCLUDE``)
_DETECTION_HOST = ("rpn_target_assign", "generate_proposal_labels",
                   "detection_map", "distribute_fpn_proposals",
                   "collect_fpn_proposals", "retinanet_detection_output",
                   "retinanet_target_assign", "generate_mask_labels")
_INTERP = ("interpolate", "resize_nearest", "resize_bilinear",
           "image_resize", "image_resize_short")
#: the functions of ``ops/nn.py`` whose layer is the op itself (the JAX
#: auto-wrap; ``fc_act`` is left out, as the JAX ``_EXCLUDE`` leaves it)
_NN_OPS = ("depthwise_conv2d", "pool3d", "adaptive_pool2d",
           "adaptive_pool3d", "sync_batch_norm", "instance_norm",
           "data_norm", "one_hot", "label_smooth", "lrn", "pad", "pad2d",
           "pad_constant_like", "pixel_shuffle", "affine_channel", "unfold",
           "space_to_depth", "shuffle_channel")

__all__ = sorted(
    {"data", "fc", "embedding", "softmax", "conv2d", "pool2d", "batch_norm",
     "dropout", "create_parameter", "linear_chain_crf", "crf_decoding",
     "while_loop", "static_rnn", "While", "Switch", "IfElse", "StaticRNN",
     "DynamicRNN", "io", "py_reader", "create_py_reader_by_data",
     "read_file", "double_buffer", "batch", "shuffle", "load", "open_files",
     "random_data_generator", "Preprocessor", "multi_box_head",
     "conv2d_transpose", "conv3d", "conv3d_transpose", "layer_norm",
     "group_norm", "hsigmoid", "hash", "continuous_value_model",
     "create_global_var", "autoincreased_step_counter", "Print", "py_func",
     "register_op_init_param", "OP_REGISTRY"}
    | {n for m in _WRAPPED for n in m.__all__}
    | set(_NN_OPS) | set(_metric.__all__)
    | set(_det.__all__) | set(_INTERP)
    | set(_rnn.__all__) | set(_seq.__all__)) + [
    "learning_rate_scheduler", "noam_decay", "exponential_decay",
    "natural_exp_decay", "inverse_time_decay", "polynomial_decay",
    "piecewise_decay", "cosine_decay", "linear_lr_warmup"]

#: ops whose leading N args are tensors (default 1), the JAX package's
#: table for the ported ops
_NARGS = {
    "elementwise_add": 2, "elementwise_sub": 2, "elementwise_mul": 2,
    "elementwise_div": 2, "elementwise_min": 2, "elementwise_max": 2,
    "elementwise_pow": 2, "elementwise_mod": 2, "elementwise_floordiv": 2,
    "minus": 2, "matmul": 2, "mul": 2, "bmm": 2, "dot": 2,
    "cross_entropy": 2, "softmax_with_cross_entropy": 2,
    "sigmoid_cross_entropy_with_logits": 2, "square_error_cost": 2,
    "smooth_l1": 2, "huber_loss": 2, "log_loss": 2, "hinge_loss": 2,
    "margin_rank_loss": 3, "rank_loss": 3, "kldiv_loss": 2, "bpr_loss": 2,
    "cos_sim": 2, "modified_huber_loss": 2, "mse_loss": 2,
    "teacher_student_sigmoid_loss": 2, "npair_loss": 3,
    "gather": 2, "gather_nd": 2, "scatter": 3, "scatter_nd_add": 3,
    "where": 3, "expand_as": 2, "pad_constant_like": 2,
    "accuracy": 2, "auc": 2,
    "logical_and": 2, "logical_or": 2, "logical_xor": 2,
    "equal": 2, "not_equal": 2, "less_than": 2, "less_equal": 2,
    "greater_than": 2, "greater_equal": 2,
    "fill_constant": 0, "zeros": 0, "ones": 0, "eye": 0,
    "linspace": 0, "arange": 0, "create_tensor": 0,
    "gaussian_random": 0, "uniform_random": 0,
    "truncated_gaussian_random": 0, "randint": 0,
    "prelu": 2, "conv2d": 2, "conv2d_transpose": 2, "conv3d": 2,
    "depthwise_conv2d": 2, "conv3d_transpose": 2, "embedding": 2,
    "layer_norm_flex": 3, "group_norm_p": 3,
    "linear_chain_crf": 3, "crf_decoding": 2, "dice_loss": 2,
    "sampled_softmax_with_cross_entropy": 2,
    "ctc_loss": 2, "warpctc": 2, "edit_distance": 2,
    "hierarchical_sigmoid": 4, "deformable_roi_pooling": 3,
    # quantization family
    "fake_quantize_range_abs_max": 3,
    "fake_quantize_moving_average_abs_max": 3,
    "fake_quantize_dequantize_moving_average_abs_max": 3,
    "moving_average_abs_max_scale": 3,
    "fake_dequantize_max_abs": 2, "quantize_linear": 2,
    "dequantize_linear": 2, "fake_channel_wise_dequantize_max_abs": 1,
    "quantized_mul": 2, "quantized_conv2d": 2,
    # detection family
    "iou_similarity": 2, "box_coder": 3, "prior_box": 2,
    "density_prior_box": 2, "bipartite_match": 1, "target_assign": 2,
    "multiclass_nms": 2, "detection_output": 4, "ssd_loss": 5,
    "yolo_box": 2, "yolov3_loss": 3, "box_clip": 2,
    "sigmoid_focal_loss": 3, "roi_align": 2, "roi_pool": 2,
    "roi_perspective_transform": 2, "mine_hard_examples": 4,
    "psroi_pool": 2, "generate_proposals": 5, "box_decoder_and_assign": 4,
}
#: ops whose first arg is a list of tensors
_LIST_FIRST = {"concat", "sums", "stack", "multiplex"}
#: a layer's arguments that never become op attrs
_NOT_ATTRS = ("name", "device", "rng")
#: ops that draw: the Executor hands each its generator (``_needs_rng``),
#: the JAX package's ``_NEEDS_RNG`` for the ported ops
_NEEDS_RNG = {"dropout", "sampled_softmax_with_cross_entropy",
              "gaussian_random", "uniform_random",
              "truncated_gaussian_random", "randint", "sampling_id",
              "random_crop", "shuffle_batch",
              "uniform_random_batch_size_like",
              "gaussian_random_batch_size_like"}
#: ops that return (outputs, final state), ``box_decoder_and_assign``,
#: ``sync_batch_norm`` and the misc ops that return a tuple: in a Program
#: the op's one output is the first (the JAX package's op count of 1 for
#: them, layers/__init__.py:112-127)
_FIRST_OUT = {"lstm", "gru", "dynamic_lstm", "dynamic_lstmp", "dynamic_gru",
              "simple_rnn", "attention_lstm", "box_decoder_and_assign",
              "sync_batch_norm", "top_k", "max_pool2d_with_index",
              "spectral_norm", "average_accumulates", "beam_search",
              "sample_logits", "lstm_unit"}
#: ops whose compute reaches a kernel: shape inference runs this plain body
_SHAPE_BODIES = {
    "embedding": _nn.embedding_reference,
    "lookup_table": lambda ids, table, padding_idx=None:
        _nn.embedding_reference(ids, table, padding_idx)}
_META = torch.device("meta")
#: op name -> its op function (the eager body of its layer)
_OPS = {}


def _bind_tensor_params(tparams, xs):
    """{parameter: tensor, or list of tensors} from the flat input list: a
    ``(name, count)`` entry regroups a list (layers/__init__.py:130)."""
    out, i = {}, 0
    for entry in tparams:
        if isinstance(entry, tuple):
            name, cnt = entry
            out[name] = list(xs[i:i + cnt])
            i += cnt
        else:
            out[entry] = xs[i]
            i += 1
    return out


def _call(fn, xs, attrs, listy):
    """``fn`` over an op's inputs: a list first, by parameter name (an op
    with promoted tensor arguments: its ``_tensor_params`` attr names its
    inputs in order) or positionally."""
    attrs = dict(attrs)
    tparams = attrs.pop("_tensor_params", None)
    if listy:
        return fn(list(xs), **attrs)
    if tparams is not None:
        return fn(**attrs, **_bind_tensor_params(tparams, xs))
    return fn(*xs, **attrs)


def _register(name, fn):
    """Register ``fn`` as op ``name``: inputs ride the "X" slot."""
    listy = name in _LIST_FIRST
    _OPS[name] = fn

    def compute(ins, attrs):
        out = _call(fn, ins.get("X", []), attrs, listy)
        return {"Out": list(out) if isinstance(out, (tuple, list))
                else [out]}

    register_op(name, compute)
    return _NARGS.get(name, 1), listy


def _sub_dyn(shape, val):
    return tuple(val if s in (None, -1) else int(s) for s in shape)


def _meta_of(v, val):
    if v.shape is None:
        raise EnforceNotMet(
            f"variable '{v.name}' has unknown shape (producer op's shape "
            f"inference failed: {getattr(v, '_shape_error', 'unknown')})")
    return torch.empty(_sub_dyn(v.shape, val), dtype=v.dtype, device=_META)


def _append_static(name, tensor_vals, attrs, listy, tensor_params=None,
                   promoted=None):
    """Append one op to the current program; returns its output Variable
    (a list of them where the op returns a list, as ``split`` does). A
    literal (non-Variable) operand becomes a program constant; attrs whose
    name starts with ``_`` are the Executor's (``_needs_rng``) and do not
    reach the op's function here. ``promoted`` is an ordered {parameter:
    Variable or list} of tensors found in attribute positions: they join
    the inputs after ``tensor_params`` (the leading tensor parameters'
    names), a list flattened, and the ``_tensor_params`` attr records all
    their names in order, a list's as ``(name, count)``."""
    program = default_main_program()
    blk = program.global_block()
    fn = _SHAPE_BODIES.get(name, _OPS[name])
    in_names, probes2, probes3 = [], [], []
    had_dyn = False
    flat = list(tensor_vals[0] if listy else tensor_vals)
    if promoted:
        params = list(tensor_params)
        for pname, pval in promoted.items():
            if isinstance(pval, (list, tuple)):
                flat.extend(pval)
                params.append((pname, len(pval)))
            else:
                flat.append(pval)
                params.append(pname)
        attrs = {k: v for k, v in attrs.items() if k not in promoted}
        attrs["_tensor_params"] = tuple(params)
    for tv in flat:
        if isinstance(tv, Variable):
            in_names.append(tv.name)
            probes2.append(_meta_of(tv, 2))
            probes3.append(_meta_of(tv, 3))
            had_dyn |= bool(tv.shape) and any(s in (-1, None)
                                              for s in tv.shape)
        else:
            if isinstance(tv, (list, tuple)) and _has_variable(tv):
                # the JAX package turns the list into an array and fails
                # the same way (``layers.sum`` of Variables)
                raise TypeError(
                    f"{name}: a list of Variables where the op takes one "
                    "tensor")
            arr = torch.as_tensor(tv)
            cname = unique_name.generate(f"const_{name}")
            blk.create_var(name=cname, shape=arr.shape, dtype=arr.dtype)
            program._constants[cname] = arr
            in_names.append(cname)
            probes2.append(arr.to(_META))
            probes3.append(arr.to(_META))

    # a tensor given in an attribute position (a constant such as
    # ``assign_value``'s) is probed on meta too
    fn_attrs = {k: v.to(_META) if isinstance(v, torch.Tensor) else v
                for k, v in attrs.items()
                if not k.startswith("_") or k == "_tensor_params"}

    def infer(xs):
        out = _call(fn, xs, fn_attrs, listy)
        return out[0] if name in _FIRST_OUT else out

    shape_error = None
    try:
        out2 = infer(probes2)
    except (RuntimeError, ValueError, TypeError, IndexError) as e:
        out2 = out3 = None
        shape_error = f"{type(e).__name__}: {e}"
    else:
        try:
            out3 = infer(probes3) if had_dyn else out2
        except (RuntimeError, ValueError, TypeError, IndexError):
            # the op traces only at the first probe (e.g. a reshape tied to
            # it): mark just the batch dim dynamic
            out3 = None
    multi = isinstance(out2, (tuple, list))
    outs2 = list(out2) if multi else [out2]
    outs3 = (list(out3) if isinstance(out3, (tuple, list))
             else [out3] * len(outs2))
    outs = []
    for o2, o3 in zip(outs2, outs3):
        shape, dtype = None, torch.float32
        if o2 is not None:
            dtype = o2.dtype
            shape = [d if o3 is None or d == o3.shape[j] else -1
                     for j, d in enumerate(o2.shape)]
            if o3 is None and had_dyn and shape and shape[0] == 2:
                shape[0] = -1
        v = blk.create_var(name=unique_name.generate(f"{name}.out"),
                           shape=shape, dtype=dtype)
        if shape is None:
            v._shape_error = shape_error
        outs.append(v)
    # the op's attrs in the JAX package's order: its own, then the
    # Executor's marks
    op_attrs = {k: v for k, v in attrs.items() if k != "_tensor_params"}
    if name in _NEEDS_RNG:
        op_attrs["_needs_rng"] = True
    if "_tensor_params" in attrs:
        op_attrs["_tensor_params"] = attrs["_tensor_params"]
    blk.append_op(type=name, inputs={"X": in_names},
                  outputs={"Out": [v.name for v in outs]}, attrs=op_attrs)
    return outs if multi else outs[0]


def _has_variable(vals):
    return any(isinstance(v, Variable)
               or (isinstance(v, (list, tuple))
                   and any(isinstance(x, Variable) for x in v))
               for v in vals)


def _dual(name, fn):
    """The layer function of op ``fn``: eager on tensors, an appended op on
    Variables. Its attrs are the op's non-tensor arguments with their
    defaults filled in, as in the JAX package (the pass pipeline reads
    them: an activation with attrs is not folded into a matmul)."""
    n_tensor, listy = _register(name, fn)
    sig = inspect.signature(fn)
    pnames = list(sig.parameters)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
        vals = bound.arguments
        if listy:
            tensor_vals = [list(vals[pnames[0]])]
            attr_names = pnames[1:]
        else:
            tensor_vals = [vals[p] for p in pnames[:n_tensor]]
            attr_names = pnames[n_tensor:]
        attrs = {p: vals[p] for p in attr_names
                 if p in vals and p not in _NOT_ATTRS}
        if in_static_mode():
            promoted = {p: v for p, v in attrs.items()
                        if _has_variable([v])}
            if promoted or _has_variable(
                    tensor_vals[0] if listy else tensor_vals):
                return _append_static(name, tensor_vals, attrs, listy,
                                      tensor_params=pnames[:n_tensor],
                                      promoted=promoted)
        return fn(*args, **kwargs)

    return wrapper


for _m in _WRAPPED:
    for _n in _m.__all__:
        if _n in _PASSTHROUGH:
            globals()[_n] = getattr(_m, _n)
        elif _n != "softmax":
            globals()[_n] = _dual(_n, getattr(_m, _n))
pool2d = _dual("pool2d", _nn.pool2d)
crf_decoding = _dual("crf_decoding", _crf.crf_decoding)
for _n in _rnn.__all__:
    globals()[_n] = _dual(_n, getattr(_rnn, _n))
for _n in _seq.__all__:
    globals()[_n] = _dual(_n, getattr(_seq, _n))
for _n in _det.__all__:
    globals()[_n] = (getattr(_det, _n) if _n in _DETECTION_HOST
                     else _dual(_n, getattr(_det, _n)))
for _n in _INTERP + _NN_OPS:
    globals()[_n] = _dual(_n, getattr(_nn, _n))
for _n in _metric.__all__:
    globals()[_n] = _dual(_n, getattr(_metric, _n))
del _m, _n
_register("linear_chain_crf", _crf.linear_chain_crf)
for _n in ("conv2d_transpose", "conv3d", "conv3d_transpose", "layer_norm",
           "group_norm"):
    _register(_n, getattr(_nn, _n))
_register("embedding", _nn.embedding)
_register("softmax", _act.softmax)
_register("conv2d", _nn.conv2d)
_register("dropout", _nn.dropout)


def softmax(input, use_cudnn=False, name=None, axis=-1):
    """fluid.layers.softmax, with the JAX layer's signature (``use_cudnn``
    is advisory there too); a static program records ``{'axis': axis}``."""
    if in_static_mode() and _has_variable([input]):
        return _append_static("softmax", [input], {"axis": axis}, False)
    return _act.softmax(input, axis=axis)


# ---------------------------------------------------------------------------
# parameterized layers
# ---------------------------------------------------------------------------
def _make_param(prefix, shape, dtype, attr, default_init, trainable=True):
    """Create a parameter in whichever context is active: in the current
    program (and its ``init_param`` op in the startup program, once per
    name), or in the module context's frame (JAX layers/__init__.py:398-
    429)."""
    attr = ParamAttr.to_attr(attr) if attr is not None else ParamAttr()
    if isinstance(attr, WeightNormParamAttr):
        return _make_weight_norm_param(prefix, shape, dtype, attr,
                                       default_init, trainable)
    init = attr.initializer or default_init
    if not in_static_mode():
        if _module.in_module_ctx():
            return _module.create_parameter(prefix, shape, dtype,
                                            initializer=init, attr=attr)
        raise EnforceNotMet(
            "parameterized layer needs a Program (use program_guard) or a "
            "module context (nn.transform / Layer.init)")
    blk = default_main_program().global_block()
    name = attr.name or unique_name.generate(prefix)
    p = blk.create_parameter(
        name, shape, dtype, trainable=attr.trainable and trainable,
        regularizer=attr.regularizer, gradient_clip=attr.gradient_clip,
        optimize_attr={"learning_rate": attr.learning_rate},
        initializer=init)
    sblk = default_startup_program().global_block()
    if not sblk.has_var(name):
        sblk.create_parameter(name, shape, dtype, initializer=init)
        sblk.append_op(type="init_param", inputs={}, outputs={"Out": [name]},
                       attrs={"initializer": init, "shape": tuple(shape),
                              "dtype": dtype_name(dtype),
                              "_needs_rng": True})
    return p


def _make_weight_norm_param(prefix, shape, dtype, attr, default_init,
                            trainable):
    """Weight normalization (``WeightNormParamAttr``; JAX
    layers/__init__.py:432-529): the parameter is ``g * v / ||v||`` with
    the norm over every axis but ``dim`` (all of them when None; each
    element of a 1-D ``v`` with ``dim`` set), ``g`` starting at the norm of
    ``v``'s initial value. In a Program ``g``'s startup op computes it from
    ``v`` (``weight_norm_init_g``); in the module context ``g``'s
    initializer does, and the names are ``{prefix}_wn_v`` / ``_g`` unless
    the attr names them, so that ``init`` and ``apply`` meet the same
    keys."""
    if attr.name:
        base = attr.name
    elif in_static_mode():
        base = unique_name.generate(prefix + "_wn")
    else:
        base = prefix + "_wn"
    init = attr.initializer or default_init
    train = attr.trainable and trainable
    plain = ParamAttr(name=base + "_v", initializer=init,
                      learning_rate=attr.learning_rate,
                      regularizer=attr.regularizer, trainable=train,
                      gradient_clip=attr.gradient_clip)
    v = _make_param(prefix + "_v", shape, dtype, plain, init, trainable)
    dim = attr.dim
    norm_axes = (None if dim is None else
                 tuple(i for i in builtins.range(len(shape)) if i != dim))
    g_shape = (shape[dim],) if dim is not None else (1,)
    if in_static_mode():
        gname = base + "_g"
        g = default_main_program().global_block().create_parameter(
            gname, g_shape, dtype, trainable=train,
            regularizer=attr.regularizer, gradient_clip=attr.gradient_clip,
            optimize_attr={"learning_rate": attr.learning_rate},
            initializer=I.Constant(1.0))
        sblk = default_startup_program().global_block()
        if not sblk.has_var(gname):
            sblk.create_parameter(gname, g_shape, dtype,
                                  initializer=I.Constant(1.0))
            sblk.append_op(type="weight_norm_init_g",
                           inputs={"X": [base + "_v"]},
                           outputs={"Out": [gname]}, attrs={"dim": dim})
    else:
        class _GInit(I.Initializer):
            def __call__(self, gen, gshape, gdtype=torch.float32):
                return _wn_norm(v.detach(), dim).reshape(gshape).to(gdtype)
        g = _make_param(prefix + "_g", g_shape, dtype,
                        ParamAttr(name=base + "_g", initializer=_GInit(),
                                  learning_rate=attr.learning_rate,
                                  regularizer=attr.regularizer,
                                  gradient_clip=attr.gradient_clip,
                                  trainable=train),
                        I.Constant(1.0), trainable)
    # w = g * v / ||v||, from the wrapped ops, so that a Program records it
    if norm_axes is None:
        sq = reduce_sum(square(v), keep_dim=True)
    elif norm_axes:
        sq = reduce_sum(square(v), dim=list(norm_axes), keep_dim=True)
    else:
        sq = square(v)
    inv = rsqrt(scale(sq, scale=1.0, bias=1e-12))
    gshape = [1] * len(shape)
    if dim is not None:
        gshape[dim] = shape[dim]
    gb = reshape(g, shape=gshape)
    return elementwise_mul(elementwise_mul(v, inv), gb)


def _wn_norm(v, dim):
    """||v|| over every axis but ``dim`` (all axes when None, each element
    when v is 1-D and ``dim`` is set)."""
    if dim is None:
        return torch.sqrt(torch.sum(torch.square(v))).reshape(1)
    axes = tuple(i for i in builtins.range(v.dim()) if i != dim)
    if not axes:
        return torch.abs(v)
    return torch.sqrt(torch.sum(torch.square(v), dim=axes))


def _init_param_compute(ins, attrs):
    """The startup program's initializer op; ``rng`` is the executor's
    generator (ops without ``_needs_rng``, constants, draw nothing). An
    int64 parameter (a step counter, a global var) holds int32 values, as
    the JAX package (x64 off) holds them; its document keeps int64."""
    dtype = convert_dtype(attrs["dtype"])
    if dtype == torch.int64:
        dtype = torch.int32
    return {"Out": [attrs["initializer"](attrs.get("rng"),
                                         tuple(attrs["shape"]), dtype)]}


def register_op_init_param():
    """(Re-)register the startup program's ``init_param`` op."""
    register_op("init_param", _init_param_compute)


register_op_init_param()
register_op("weight_norm_init_g", lambda ins, attrs: {
    "Out": [_wn_norm(ins["X"][0], attrs.get("dim"))]})


def create_parameter(shape, dtype="float32", name=None, attr=None,
                     is_bias=False, default_initializer=None):
    """fluid.layers.create_parameter parity: in a Program or the module
    context, Constant(0) for a bias and Xavier otherwise by default."""
    default = default_initializer or (
        I.Constant(0.0) if is_bias else I.Xavier())
    if attr is None and name is not None:
        attr = ParamAttr(name=name)
    return _make_param(name or "param", tuple(shape), convert_dtype(dtype),
                       attr, default)


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """fluid.layers.fc parity: ``mul`` per input, one shared bias added at
    ``num_flatten_dims``, then ``act``. The pass pipeline folds the chain
    into one ``fused_matmul`` op."""
    inputs = list(input) if isinstance(input, (list, tuple)) else [input]
    attrs = (list(param_attr) if isinstance(param_attr, (list, tuple))
             else [param_attr] * len(inputs))
    out = None
    for x, pa in zip(inputs, attrs):
        in_dim = 1
        for d in x.shape[num_flatten_dims:]:
            if d in (-1, None):
                raise EnforceNotMet(
                    f"fc: flattened input dims must be static, got shape "
                    f"{x.shape} with num_flatten_dims={num_flatten_dims}")
            in_dim *= int(d)
        w = _make_param("fc_w", (in_dim, size), torch.float32, pa,
                        I.Xavier())
        o = mul(x, w, x_num_col_dims=num_flatten_dims)
        out = o if out is None else elementwise_add(out, o)
    if bias_attr is not False:
        b = _make_param("fc_b", (size,), torch.float32, bias_attr,
                        I.Constant(0.0))
        out = elementwise_add(out, b, axis=num_flatten_dims)
    return _apply_act(out, act)


def _apply_act(x, act):
    """``act`` by name: any layer of this module (an activation), as the
    JAX layers apply it."""
    if act is None:
        return x
    fn = globals().get(act)
    if fn is None:
        raise EnforceNotMet(f"unknown activation {act!r}")
    return fn(x)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    """fluid.layers.embedding / lookup_table parity. ``is_sparse`` and
    ``is_distributed`` are advisory, as in the JAX package."""
    w = _make_param("emb_w", tuple(size), convert_dtype(dtype), param_attr,
                    I.Xavier())
    pi = padding_idx if padding_idx is None or padding_idx >= 0 \
        else size[0] + padding_idx
    if in_static_mode() and isinstance(input, Variable):
        return _append_static("embedding", [input, w], {"padding_idx": pi},
                              False)
    return _nn.embedding(input, w, pi)


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None,
           use_cudnn=True, name=None, data_format="NCHW"):
    """fluid.layers.conv2d parity: an OIHW weight drawn by
    ``MSRA(uniform=False)``, the ``conv2d`` op, a bias added on axis 1,
    then ``act``. ``use_cudnn`` is advisory, as in the JAX package."""
    c_in = int(input.shape[1] if data_format == "NCHW" else input.shape[-1])
    fs = filter_size if isinstance(filter_size, (list, tuple)) \
        else (filter_size, filter_size)
    w = _make_param("conv2d_w", (num_filters, c_in // groups) + tuple(fs),
                    torch.float32, param_attr, I.MSRA(uniform=False))
    out = _conv_layer("conv2d", input, w, dict(
        stride=stride, padding=padding, dilation=dilation, groups=groups,
        data_format=data_format))
    return _bias_act(out, "conv2d", num_filters, bias_attr, act)


def _conv_layer(op, input, w, attrs):
    """The convolution op ``op`` over input and weight: appended to the
    Program, or computed at once."""
    if in_static_mode() and isinstance(input, Variable):
        return _append_static(op, [input, w], attrs, False)
    return getattr(_nn, op)(input, w, **attrs)


def _bias_act(out, prefix, num_filters, bias_attr, act):
    """A bias ``{prefix}_b`` added on axis 1 (unless ``bias_attr`` is
    False), then ``act``."""
    if bias_attr is not False:
        b = _make_param(f"{prefix}_b", (num_filters,), torch.float32,
                        bias_attr, I.Constant(0.0))
        out = elementwise_add(out, b, axis=1)
    return _apply_act(out, act)


def _infer_transpose_fs(input, output_size, stride, padding, dilation, nd):
    """A transposed convolution's filter size from ``output_size`` (ref
    layers/nn.py conv2d_transpose): (output + 2 * pad - (in - 1) * stride
    + dilation - 1) // dilation per dim."""
    def per_dim(v):
        return v if isinstance(v, (list, tuple)) else (v,) * nd
    outs, sts, pds, dls = (per_dim(v) for v in (output_size, stride,
                                                  padding, dilation))
    return tuple((int(outs[i]) + 2 * pds[i]
                  - (int(input.shape[2 + i]) - 1) * sts[i] + dls[i] - 1)
                 // dls[i] for i in builtins.range(nd))


def _conv_transpose(op, nd, input, num_filters, output_size, filter_size,
                    stride, padding, dilation, groups, param_attr, bias_attr,
                    act):
    """conv2d_transpose / conv3d_transpose: an I O(/groups) k.. weight drawn
    by ``Xavier()``, the op, a bias, then ``act`` (the JAX layers)."""
    if filter_size is None:
        if output_size is None:
            raise EnforceNotMet(
                f"{op}: one of output_size or filter_size is required "
                "(layers/nn.py conv2d_transpose)")
        filter_size = _infer_transpose_fs(input, output_size, stride,
                                          padding, dilation, nd)
    fs = filter_size if isinstance(filter_size, (list, tuple)) \
        else (filter_size,) * nd
    prefix = "conv2dT" if nd == 2 else "conv3dT"
    w = _make_param(f"{prefix}_w",
                    (int(input.shape[1]), num_filters // groups) + tuple(fs),
                    torch.float32, param_attr, I.Xavier())
    out = _conv_layer(op, input, w, dict(stride=stride, padding=padding,
                                         dilation=dilation, groups=groups))
    return _bias_act(out, prefix, num_filters, bias_attr, act)


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     stride=1, padding=0, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, act=None,
                     use_cudnn=True, name=None):
    """fluid.layers.conv2d_transpose parity: an IOHW weight (Xavier), the
    ``conv2d_transpose`` op, a bias on axis 1, then ``act``; the filter size
    from ``output_size`` when only that is given."""
    return _conv_transpose("conv2d_transpose", 2, input, num_filters,
                           output_size, filter_size, stride, padding,
                           dilation, groups, param_attr, bias_attr, act)


def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None,
           use_cudnn=True, name=None):
    """fluid.layers.conv3d parity (NCDHW): an OIDHW weight drawn by
    ``MSRA(uniform=False)``, the ``conv3d`` op, a bias, then ``act``."""
    fs = filter_size if isinstance(filter_size, (list, tuple)) \
        else (filter_size,) * 3
    w = _make_param("conv3d_w",
                    (num_filters, int(input.shape[1]) // groups) + tuple(fs),
                    torch.float32, param_attr, I.MSRA(uniform=False))
    out = _conv_layer("conv3d", input, w, dict(
        stride=stride, padding=padding, dilation=dilation, groups=groups))
    return _bias_act(out, "conv3d", num_filters, bias_attr, act)


def conv3d_transpose(input, num_filters, output_size=None, filter_size=None,
                     stride=1, padding=0, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, act=None,
                     use_cudnn=True, name=None):
    """fluid.layers.conv3d_transpose parity: an IODHW weight (Xavier)."""
    return _conv_transpose("conv3d_transpose", 3, input, num_filters,
                           output_size, filter_size, stride, padding,
                           dilation, groups, param_attr, bias_attr, act)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    """fluid.layers.layer_norm parity: a flat scale (1) and shift (0) over
    the normalized dims, as the JAX layer makes them, and one
    ``layer_norm_flex`` op."""
    flat = math.prod(int(d) for d in input.shape[begin_norm_axis:])
    s = _make_param("ln_scale", (flat,), torch.float32, param_attr,
                    I.Constant(1.0)) if scale else None
    b = _make_param("ln_bias", (flat,), torch.float32, bias_attr,
                    I.Constant(0.0)) if shift else None
    tensors = [t for t in (input, s, b) if t is not None]
    attrs = {"begin_norm_axis": begin_norm_axis, "epsilon": epsilon,
             "has_scale": s is not None, "has_bias": b is not None}
    if in_static_mode() and isinstance(input, Variable):
        return _apply_act(_append_static("layer_norm_flex", tensors, attrs,
                                         False), act)
    return _apply_act(_ln_flex(*tensors, **attrs), act)


def _ln_flex(*tensors, begin_norm_axis=1, epsilon=1e-5, has_scale=True,
             has_bias=True):
    it = iter(tensors)
    x = next(it)
    s = next(it) if has_scale else None
    b = next(it) if has_bias else None
    return _nn.layer_norm(x, s, b, begin_norm_axis, epsilon)


def group_norm(input, groups, epsilon=1e-5, param_attr=None, bias_attr=None,
               act=None, data_layout="NCHW", name=None):
    """fluid.layers.group_norm parity: per-channel scale (1) and bias (0)
    and one ``group_norm_p`` op (NCHW)."""
    c = int(input.shape[1])
    s = _make_param("gn_scale", (c,), torch.float32, param_attr,
                    I.Constant(1.0))
    b = _make_param("gn_bias", (c,), torch.float32, bias_attr,
                    I.Constant(0.0))
    if in_static_mode() and isinstance(input, Variable):
        return _apply_act(_append_static(
            "group_norm_p", [input, s, b],
            {"groups": groups, "epsilon": epsilon}, False), act)
    return _apply_act(_gn_p(input, s, b, groups=groups, epsilon=epsilon),
                      act)


def _gn_p(x, s, b, groups=32, epsilon=1e-5):
    return _nn.group_norm(x, s, b, groups, epsilon)


_register("layer_norm_flex", _ln_flex)
_register("group_norm_p", _gn_p)


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               name=None, moving_mean_name=None, moving_variance_name=None,
               use_global_stats=False):
    """fluid.layers.batch_norm parity: scale and bias parameters, then,
    in a Program, the moving mean and variance as non-trainable persistable
    parameters (0 and 1) and one ``batch_norm`` op whose ``MeanOut`` and
    ``VarianceOut`` overwrite them; outside one (the module context), the
    running stats as ``nn`` state (``bn_mean``, ``bn_variance``), which a
    training call overwrites, and the op at once."""
    c = int(input.shape[1] if data_layout == "NCHW" else input.shape[-1])
    scale_p = _make_param("bn_scale", (c,), torch.float32, param_attr,
                          I.Constant(1.0))
    bias_p = _make_param("bn_bias", (c,), torch.float32, bias_attr,
                         I.Constant(0.0))
    if not (in_static_mode() and isinstance(input, Variable)):
        mean = _module.create_state("bn_mean", (c,), torch.float32, 0.0)
        var = _module.create_state("bn_variance", (c,), torch.float32, 1.0)
        out, m_out, v_out, _, _ = _nn.batch_norm(
            input, scale_p, bias_p, mean, var, epsilon, momentum, is_test,
            data_layout, use_global_stats)
        if not is_test:
            _module.set_state("bn_mean", m_out.detach())
            _module.set_state("bn_variance", v_out.detach())
        return _apply_act(out, act)
    mean = _make_param(moving_mean_name or "bn_mean", (c,), torch.float32,
                       ParamAttr(name=moving_mean_name, trainable=False),
                       I.Constant(0.0), trainable=False)
    var = _make_param(moving_variance_name or "bn_variance", (c,),
                      torch.float32,
                      ParamAttr(name=moving_variance_name, trainable=False),
                      I.Constant(1.0), trainable=False)
    blk = default_main_program().global_block()
    out = blk.create_var(name=unique_name.generate("bn.out"),
                         shape=input.shape, dtype=input.dtype)
    blk.append_op(
        type="batch_norm",
        inputs={"X": [input.name, scale_p.name, bias_p.name, mean.name,
                      var.name]},
        outputs={"Out": [out.name], "MeanOut": [mean.name],
                 "VarianceOut": [var.name]},
        attrs={"epsilon": epsilon, "momentum": momentum, "is_test": is_test,
               "data_layout": data_layout,
               "use_global_stats": use_global_stats})
    return _apply_act(out, act)


def _bn_compute(ins, attrs):
    x, scale_t, bias_t, mean, var = ins["X"]
    out, m_out, v_out, _, _ = _nn.batch_norm(
        x, scale_t, bias_t, mean, var, attrs["epsilon"], attrs["momentum"],
        attrs["is_test"], attrs["data_layout"], attrs["use_global_stats"])
    return {"Out": [out], "MeanOut": [m_out], "VarianceOut": [v_out]}


register_op("batch_norm", _bn_compute)


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    """fluid.layers.dropout parity. In a Program: a ``dropout`` op that
    draws from the Executor's generator (``seed`` is not recorded, as in
    the JAX package); outside one: the op at once, its generator made from
    ``seed`` (the JAX layer's branch outside a module)."""
    if in_static_mode() and isinstance(x, Variable):
        return _append_static(
            "dropout", [x],
            {"dropout_prob": dropout_prob, "is_test": is_test,
             "dropout_implementation": dropout_implementation}, False)
    return _nn.dropout(x, dropout_prob, is_test, seed,
                       dropout_implementation)


def linear_chain_crf(input, label, param_attr=None, length=None):
    """fluid.layers.linear_chain_crf parity: creates the ``crfw``
    transition parameter ([num_tags+2, num_tags], ref: operators/
    linear_chain_crf_op.cc OpMaker) and returns the per-sequence negative
    log-likelihood. In a Program, ``length`` (when given) is the op's
    fourth input. Decode with crf_decoding(input, crfw)."""
    num_tags = int(input.shape[-1])
    w = _make_param("crfw", (num_tags + 2, num_tags), torch.float32,
                    param_attr, I.Xavier())
    if in_static_mode() and isinstance(input, Variable):
        tensors = [input, w, label]
        if length is not None:
            tensors.append(length)
        return _append_static("linear_chain_crf", tensors, {}, False)
    return _crf.linear_chain_crf(input, w, label, length)


def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None,
                   max_sizes=None, steps=None, step_w=None, step_h=None,
                   offset=0.5, variance=(0.1, 0.1, 0.2, 0.2), flip=True,
                   clip=False, kernel_size=1, pad=0, stride=1, name=None,
                   min_max_aspect_ratios_order=False):
    """SSD multi-box head (ref python/paddle/fluid/layers/detection.py:1737),
    as the JAX layer builds it (layers/__init__.py:970-1077): per feature
    map, ``prior_box`` and two convs predicting locations (P*4 channels)
    and confidences (P*num_classes channels), transposed to NHWC and
    flattened; everything concatenated across maps.

    The convs' parameters are ``{tag}_loc{i}_w/_b`` and
    ``{tag}_conf{i}_w/_b``: in a Program the tag is
    ``unique_name.generate("multi_box_head")`` (or ``name``), in the module
    context ``"mbh"`` under the frame scope ``multi_box_head``, so a scope
    or a parameter dict of the JAX package's carries over.

    Returns (mbox_locs [N, B, 4], mbox_confs [N, B, num_classes],
    boxes [B, 4], variances [B, 4]) with B the total prior count.
    """
    if not isinstance(inputs, (list, tuple)):
        raise EnforceNotMet("inputs should be a list or tuple")
    num_layer = len(inputs)
    if num_layer <= 2:
        if min_sizes is None or max_sizes is None or \
                len(min_sizes) != num_layer or len(max_sizes) != num_layer:
            raise EnforceNotMet(
                "with <=2 input layers, min_sizes/max_sizes must be "
                "given per layer")
    elif min_sizes is None and max_sizes is None:
        min_sizes, max_sizes = [], []
        step = int(math.floor((max_ratio - min_ratio) / (num_layer - 2)))
        for ratio in builtins.range(min_ratio, max_ratio + 1, step):
            min_sizes.append(base_size * ratio / 100.0)
            max_sizes.append(base_size * (ratio + step) / 100.0)
        min_sizes = [base_size * 0.10] + min_sizes
        max_sizes = [base_size * 0.20] + max_sizes
    if steps:
        step_w = step_h = steps
    if _module.in_module_ctx():
        scope, tag = _module._frame().scope("multi_box_head"), name or "mbh"
    else:
        scope = contextlib.nullcontext()
        tag = name or unique_name.generate("multi_box_head")
    with scope:
        return _multi_box_head_maps(
            inputs, image, num_classes, aspect_ratios, min_sizes, max_sizes,
            step_w, step_h, offset, variance, flip, clip, kernel_size, pad,
            stride, min_max_aspect_ratios_order, tag)


def _multi_box_head_maps(inputs, image, num_classes, aspect_ratios,
                         min_sizes, max_sizes, step_w, step_h, offset,
                         variance, flip, clip, kernel_size, pad, stride,
                         min_max_aspect_ratios_order, tag):
    locs, confs, boxes, variances = [], [], [], []
    for i, inp in enumerate(inputs):
        min_size, max_size = min_sizes[i], max_sizes[i]
        if not isinstance(min_size, (list, tuple)):
            min_size = [min_size]
        if not isinstance(max_size, (list, tuple)):
            max_size = [max_size]
        ar = aspect_ratios[i] if aspect_ratios is not None else []
        if not isinstance(ar, (list, tuple)):
            ar = [ar]
        step = (step_w[i] if step_w else 0.0, step_h[i] if step_h else 0.0)
        box, var = prior_box(inp, image, list(min_size), list(max_size),
                             list(ar), list(variance), flip, clip, step,
                             offset, min_max_aspect_ratios_order)
        boxes.append(box)
        variances.append(var)
        num_boxes = box.shape[2]           # priors per cell
        for kind, width, out in (("loc", 4, locs),
                                 ("conf", num_classes, confs)):
            y = conv2d(inp, num_boxes * width, kernel_size, stride=stride,
                       padding=pad,
                       param_attr=ParamAttr(name=f"{tag}_{kind}{i}_w"),
                       bias_attr=ParamAttr(name=f"{tag}_{kind}{i}_b"))
            out.append(flatten(transpose(y, perm=[0, 2, 3, 1]), axis=1))
    if len(boxes) == 1:
        box, var, loc, conf = boxes[0], variances[0], locs[0], confs[0]
    else:
        box = concat([flatten(b, axis=3) for b in boxes])
        var = concat([flatten(v, axis=3) for v in variances])
        loc = concat(locs, axis=1)
        conf = concat(confs, axis=1)
    box = reshape(box, shape=[-1, 4])
    var = reshape(var, shape=[-1, 4])
    return (reshape(loc, shape=[0, -1, 4]),
            reshape(conf, shape=[0, -1, num_classes]), box, var)


# ---------------------------------------------------------------------------
# control flow with callable bodies: the wrapping treats every positional
# argument as a tensor, so these two get explicit duals. In a Program the
# bodies are traced into serializable sub-programs (static/nested.py, ref
# while_op.cc / recurrent_op.cc sub-blocks); outside one they run as eager
# Python loops (ops/control_flow.py).
# ---------------------------------------------------------------------------
def while_loop(cond, body, loop_vars, is_test=False, name=None):
    lv = loop_vars if isinstance(loop_vars, (list, tuple)) else [loop_vars]
    if in_static_mode() and _has_variable(list(lv)):
        from paddle_tpu_torch.static.nested import static_while_loop
        return static_while_loop(cond, body, loop_vars)
    return _cf.while_loop(cond, body, loop_vars)


def static_rnn(step_fn, inputs, initial_state):
    if in_static_mode() and _has_variable(
            list(inputs if isinstance(inputs, (list, tuple))
                 else [inputs])):
        from paddle_tpu_torch.static.nested import static_rnn_block
        return static_rnn_block(step_fn, inputs, initial_state)
    return _cf.static_rnn(step_fn, inputs, initial_state)


# ---------------------------------------------------------------------------
# layers' own functions (paddle_tpu/layers/__init__.py:539-567, 874-968,
# 1135-1198)
# ---------------------------------------------------------------------------
def create_global_var(shape, value, dtype="float32", persistable=False,
                      force_cpu=False, name=None):
    """fluid.layers.create_global_var parity: a non-trainable parameter
    holding ``value`` (a Constant initializer)."""
    return _make_param(name or "gvar", tuple(shape), convert_dtype(dtype),
                       ParamAttr(name=name, trainable=False),
                       I.Constant(value), trainable=False)


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None,
             name=None, path_table=None, path_code=None, is_custom=False,
             is_sparse=False):
    """fluid.layers.hsigmoid parity (hierarchical_sigmoid_op.cc): the
    internal nodes' weight ``hsigmoid_w`` [C - 1, D] (Xavier) and bias
    ``hsigmoid_b`` [C - 1] (0), then ``hierarchical_sigmoid`` over the
    default complete binary tree; [B, 1] losses. A custom tree
    (``path_table``/``path_code``) is not supported, as in the JAX
    package."""
    if is_custom or path_table is not None or path_code is not None:
        raise NotImplementedError("hsigmoid: default complete tree only")
    dim = int(input.shape[-1])
    w = _make_param("hsigmoid_w", (num_classes - 1, dim), torch.float32,
                    param_attr, I.Xavier())
    if bias_attr is not False:
        b = _make_param("hsigmoid_b", (num_classes - 1,), torch.float32,
                        bias_attr, I.Constant(0.0))
    else:
        b = torch.zeros((num_classes - 1,), device=(
            None if isinstance(input, Variable) else input.device))
    lab = reshape(label, shape=[-1])       # the op walks flat [B] leaf ids
    out = hierarchical_sigmoid(input, w, b, lab, num_classes)
    return reshape(out, shape=[-1, 1])


def hash(input, hash_size, num_hash=1, name=None):  # noqa: A001
    """fluid.layers.hash parity (hash_op.cc) over ``hash_embedding_ids``:
    ``num_hash`` hashes of the ids modulo ``hash_size``."""
    return hash_embedding_ids(input, hash_size, num_hash=num_hash)


def continuous_value_model(input, cvm_input=None, use_cvm=True):
    """fluid.layers.continuous_value_model parity (cvm_op.cc): the show and
    click columns are the input's first two, as the op kernel reads them."""
    return cvm(input, use_cvm=use_cvm)


def _increment_inplace_compute(ins, attrs):
    x = ins["X"][0]
    return {"Out": [x + torch.as_tensor(attrs.get("value", 1)).to(
        x.device, x.dtype)]}


register_op("increment_inplace", _increment_inplace_compute)


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """fluid.layers.autoincreased_step_counter parity (layers/nn.py): a
    persistable counter ``@STEP_COUNTER@`` that starts at ``begin - 1``, and
    an ``increment_inplace`` op adding ``step`` that writes the counter
    itself, so the Executor puts it back in the scope after every run (the
    first run reads ``begin - 1 + step``). Each call appends one more
    increment, as in the JAX package. The int64 request is kept in the
    document; the value is int32 (``init_param``), as the JAX package (x64
    off) holds it."""
    name = counter_name or "@STEP_COUNTER@"
    blk = default_main_program().global_block()
    if blk.has_var(name):
        counter = blk.var(name)
    else:
        counter = create_global_var([1], float(begin - 1), dtype="int64",
                                    persistable=True, name=name)
    blk.append_op(type="increment_inplace", inputs={"X": [name]},
                  outputs={"Out": [name]}, attrs={"value": step})
    return counter


def _host_array(v):
    """A numpy copy of a tensor (bf16 as fp32) or an array-like."""
    if isinstance(v, torch.Tensor):
        v = v.detach()
        return (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
    return np.asarray(v)


def _print_cb(msg, summarize, counter, first_n, arr):
    """One ``Print`` line on stderr, as the JAX package's ``_print_cb``
    formats it (from a numpy copy)."""
    counter["n"] += 1
    if first_n and first_n > 0 and counter["n"] > first_n:
        return
    arr = _host_array(arr)
    flat = arr.reshape(-1)[:summarize] if summarize and summarize > 0 \
        else arr.reshape(-1)
    print(f"{msg}shape={arr.shape} dtype={arr.dtype} "
          f"data={np.array2string(flat, precision=6)}", file=sys.stderr)


def _print_compute(ins, attrs):
    """The ``print`` op: logs its input (at most ``first_n`` runs) and
    returns it, the identity for autodiff (print_op.cc's grad forwards the
    gradient). A ``meta`` input (the cost monitor's abstract pass) has no
    values: nothing is logged and the run is not counted."""
    x = ins["X"][0]
    if not (isinstance(x, torch.Tensor) and x.device.type == "meta"):
        _print_cb(attrs.get("message", ""), attrs.get("summarize", 20),
                  attrs["_counter"], attrs.get("first_n", -1), x)
    return {"Out": [x]}


register_op("print", _print_compute)


def Print(input, first_n=-1, message=None, summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=False,
          print_phase="both"):
    """fluid.layers.Print parity (operators/print_op.cc): in a Program a
    ``print`` op that logs the tensor on every run (at most ``first_n``
    times) and passes it through; outside one, the line at once."""
    msg = (message + " ") if message else ""
    counter = {"n": 0}
    if in_static_mode() and isinstance(input, Variable):
        blk = input.block
        out = blk.create_var(shape=input.shape, dtype=input.dtype)
        blk.append_op("print", inputs={"X": [input.name]},
                      outputs={"Out": [out.name]},
                      attrs={"message": msg, "summarize": summarize,
                             "first_n": first_n, "_counter": counter})
        return out
    _print_cb(msg, summarize, counter, -1, input)
    return input


#: the JAX package's dtypes with x64 off
_CANONICAL = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
              np.dtype(np.uint64): np.uint32,
              np.dtype(np.complex128): np.complex64}


def _py_func_compute(ins, attrs):
    """The ``py_func`` host op: ``func`` on numpy copies of the inputs; its
    outputs as tensors on the inputs' device, in the dtypes ``jnp.asarray``
    gives with x64 off (float64 becomes float32, int64 int32). They carry
    no gradient."""
    xs = ins["X"]
    device = next((x.device for x in xs if isinstance(x, torch.Tensor)),
                  torch.device("cpu"))
    outs = attrs["func"](*[_host_array(x) for x in xs])
    if not isinstance(outs, (list, tuple)):
        outs = [outs]
    res = []
    for o in outs:
        a = np.asarray(o)
        a = a.astype(_CANONICAL.get(a.dtype, a.dtype), copy=False)
        res.append(torch.from_numpy(np.ascontiguousarray(a)).to(device))
    return {"Out": res}


register_op("py_func", _py_func_compute)


def py_func(func, x, out, backward_func=None,
            skip_vars_in_backward_input=None):
    """fluid.layers.py_func parity (operators/py_func_op.cc): run a Python
    callable on host values mid-program. In a Program a host op (``_host``)
    that the Executor runs between the device ops; ``backward_func`` is
    taken for the API and not used: the outputs carry no gradient, and a
    py_func that a differentiated value reaches before the loss raises, as
    in the JAX package. Outside a Program, the call at once."""
    xs = x if isinstance(x, (list, tuple)) else [x]
    outs = out if isinstance(out, (list, tuple)) else [out]
    if in_static_mode() and all(isinstance(v, Variable) for v in xs):
        blk = xs[0].block
        blk.append_op("py_func", inputs={"X": [v.name for v in xs]},
                      outputs={"Out": [o.name for o in outs]},
                      attrs={"func": func, "_host": True})
        return outs if isinstance(out, (list, tuple)) else outs[0]
    res = _py_func_compute({"X": list(xs)}, {"func": func})["Out"]
    return res if isinstance(out, (list, tuple)) else res[0]


# fluid.layers.io surface (reader builders; see layers/io.py)
from paddle_tpu_torch.layers import io  # noqa: E402
from paddle_tpu_torch.layers.io import (  # noqa: E402,F401
    Preprocessor, batch, create_py_reader_by_data, double_buffer, load,
    open_files, py_reader, random_data_generator, read_file, shuffle,
)
