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
``tensor_ops``, ``loss``, ``control_flow`` and ``tensor_array`` is wrapped
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

``dropout`` is an op that draws (``_needs_rng``): the Executor hands it a
generator on its device, seeded from the program's ``random_seed``, the run
and the op. ``batch_norm`` in a Program keeps its moving mean and variance
as non-trainable persistable parameters, which its op's ``MeanOut`` and
``VarianceOut`` overwrite; outside a Program its running stats would be
module state, which it does not keep yet (queue 1 item 7d): it raises.

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
package's ``_append_static`` records them; the recurrent ops' op yields one
Variable, the outputs (their final state is not an output of the op).
"""

import functools
import inspect

import torch

from paddle_tpu_torch import initializer as I
from paddle_tpu_torch.core.dtypes import convert_dtype, dtype_name
from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.framework import ParamAttr, unique_name
from paddle_tpu_torch.layers import learning_rate_scheduler
from paddle_tpu_torch.layers.learning_rate_scheduler import (
    cosine_decay, exponential_decay, inverse_time_decay, linear_lr_warmup,
    natural_exp_decay, noam_decay, piecewise_decay, polynomial_decay,
)
from paddle_tpu_torch.nn import module as _module
from paddle_tpu_torch.ops import activation as _act
from paddle_tpu_torch.ops import control_flow as _cf
from paddle_tpu_torch.ops import crf as _crf
from paddle_tpu_torch.ops import loss as _loss
from paddle_tpu_torch.ops import math as _math
from paddle_tpu_torch.ops import nn as _nn
from paddle_tpu_torch.ops import reduce as _reduce
from paddle_tpu_torch.ops import rnn as _rnn
from paddle_tpu_torch.ops import sequence as _seq
from paddle_tpu_torch.ops import tensor_array as _ta
from paddle_tpu_torch.ops import tensor_ops as _tensor
from paddle_tpu_torch.layers.control_flow_classes import (
    DynamicRNN, IfElse, StaticRNN, Switch, While,
)
from paddle_tpu_torch.static.program import (
    Variable, default_main_program, default_startup_program,
    in_static_mode, data, register_op,
)

#: the op modules whose every function ``layers`` wraps (the JAX package
#: wraps every exported op, layers/__init__.py:340-360)
_WRAPPED = (_act, _math, _reduce, _tensor, _loss, _cf, _ta)

__all__ = sorted(
    {"data", "fc", "embedding", "softmax", "conv2d", "pool2d", "batch_norm",
     "dropout", "create_parameter", "linear_chain_crf", "crf_decoding",
     "while_loop", "static_rnn", "While", "Switch", "IfElse", "StaticRNN",
     "DynamicRNN", "io", "py_reader", "create_py_reader_by_data",
     "read_file", "double_buffer", "batch", "shuffle", "load", "open_files",
     "random_data_generator", "Preprocessor"}
    | {n for m in _WRAPPED for n in m.__all__}
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
    "where": 3, "expand_as": 2,
    "logical_and": 2, "logical_or": 2, "logical_xor": 2,
    "equal": 2, "not_equal": 2, "less_than": 2, "less_equal": 2,
    "greater_than": 2, "greater_equal": 2,
    "fill_constant": 0, "zeros": 0, "ones": 0, "eye": 0,
    "linspace": 0, "arange": 0, "create_tensor": 0,
    "prelu": 2, "conv2d": 2, "embedding": 2,
    "linear_chain_crf": 3, "crf_decoding": 2, "dice_loss": 2,
    "sampled_softmax_with_cross_entropy": 2,
}
#: ops whose first arg is a list of tensors
_LIST_FIRST = {"concat", "sums", "stack", "multiplex"}
#: a layer's arguments that never become op attrs
_NOT_ATTRS = ("name", "device")
#: ops that return (outputs, final state): in a Program the op's one output
#: is the first (the JAX package's op count of 1 for them)
_FIRST_OUT = {"lstm", "gru", "dynamic_lstm", "dynamic_lstmp", "dynamic_gru",
              "simple_rnn", "attention_lstm"}
#: ops whose compute reaches a kernel: shape inference runs this plain body
_SHAPE_BODIES = {"embedding": _nn.embedding_reference}
_META = torch.device("meta")
#: op name -> its op function (the eager body of its layer)
_OPS = {}


def _call(fn, xs, attrs, listy):
    """``fn`` over an op's inputs: a list first, by parameter name (an op
    with promoted tensor arguments: its ``_tensor_params`` attr names its
    inputs in order) or positionally."""
    attrs = dict(attrs)
    tparams = attrs.pop("_tensor_params", None)
    if listy:
        return fn(list(xs), **attrs)
    if tparams is not None:
        return fn(**attrs, **dict(zip(tparams, xs)))
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
    Variable} of tensors found in attribute positions: they join the
    inputs after ``tensor_params`` (the leading tensor parameters' names),
    and the ``_tensor_params`` attr records all their names in order."""
    program = default_main_program()
    blk = program.global_block()
    fn = _SHAPE_BODIES.get(name, _OPS[name])
    in_names, probes2, probes3 = [], [], []
    had_dyn = False
    flat = list(tensor_vals[0] if listy else tensor_vals)
    if promoted:
        flat += list(promoted.values())
        attrs = {k: v for k, v in attrs.items() if k not in promoted}
        attrs["_tensor_params"] = tuple(tensor_params) + tuple(promoted)
    for tv in flat:
        if isinstance(tv, Variable):
            in_names.append(tv.name)
            probes2.append(_meta_of(tv, 2))
            probes3.append(_meta_of(tv, 3))
            had_dyn |= bool(tv.shape) and any(s in (-1, None)
                                              for s in tv.shape)
        else:
            arr = torch.as_tensor(tv)
            cname = unique_name.generate(f"const_{name}")
            blk.create_var(name=cname, shape=arr.shape, dtype=arr.dtype)
            program._constants[cname] = arr
            in_names.append(cname)
            probes2.append(arr.to(_META))
            probes3.append(arr.to(_META))

    fn_attrs = {k: v for k, v in attrs.items()
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
    blk.append_op(type=name, inputs={"X": in_names},
                  outputs={"Out": [v.name for v in outs]}, attrs=dict(attrs))
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
                        if isinstance(v, Variable)}
            if any(isinstance(v, (list, tuple)) and _has_variable(v)
                   for v in attrs.values()):
                raise EnforceNotMet(
                    f"{name}: a list of Variables in an attribute position "
                    "is not ported yet (ROADMAP queue 1 item 4)")
            if promoted or _has_variable(
                    tensor_vals[0] if listy else tensor_vals):
                return _append_static(name, tensor_vals, attrs, listy,
                                      tensor_params=pnames[:n_tensor],
                                      promoted=promoted)
        return fn(*args, **kwargs)

    return wrapper


for _m in _WRAPPED:
    for _n in _m.__all__:
        if _n != "softmax":
            globals()[_n] = _dual(_n, getattr(_m, _n))
pool2d = _dual("pool2d", _nn.pool2d)
crf_decoding = _dual("crf_decoding", _crf.crf_decoding)
for _n in _rnn.__all__:
    globals()[_n] = _dual(_n, getattr(_rnn, _n))
for _n in _seq.__all__:
    globals()[_n] = _dual(_n, getattr(_seq, _n))
del _m, _n
_register("linear_chain_crf", _crf.linear_chain_crf)
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


def _init_param_compute(ins, attrs):
    """The startup program's initializer op; ``rng`` is the executor's
    generator (ops without ``_needs_rng``, constants, draw nothing)."""
    return {"Out": [attrs["initializer"](attrs.get("rng"),
                                         tuple(attrs["shape"]),
                                         convert_dtype(attrs["dtype"]))]}


register_op("init_param", _init_param_compute)


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
    attrs = dict(stride=stride, padding=padding, dilation=dilation,
                 groups=groups, data_format=data_format)
    if in_static_mode() and isinstance(input, Variable):
        out = _append_static("conv2d", [input, w], attrs, False)
    else:
        out = _nn.conv2d(input, w, **attrs)
    if bias_attr is not False:
        b = _make_param("conv2d_b", (num_filters,), torch.float32, bias_attr,
                        I.Constant(0.0))
        out = elementwise_add(out, b, axis=1)
    return _apply_act(out, act)


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               name=None, moving_mean_name=None, moving_variance_name=None,
               use_global_stats=False):
    """fluid.layers.batch_norm parity in a Program: scale and bias
    parameters, the moving mean and variance as non-trainable persistable
    parameters (0 and 1), and one ``batch_norm`` op whose ``MeanOut`` and
    ``VarianceOut`` overwrite them. Outside a Program the running stats
    need the module context, which is not ported yet: it raises."""
    if not (in_static_mode() and isinstance(input, Variable)):
        raise EnforceNotMet(
            "batch_norm outside a Program keeps its running stats in the "
            "module context (nn state), which is not ported yet (ROADMAP "
            "queue 1 item 7d)")
    c = int(input.shape[1] if data_layout == "NCHW" else input.shape[-1])
    scale_p = _make_param("bn_scale", (c,), torch.float32, param_attr,
                          I.Constant(1.0))
    bias_p = _make_param("bn_bias", (c,), torch.float32, bias_attr,
                         I.Constant(0.0))
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
             "dropout_implementation": dropout_implementation,
             "_needs_rng": True}, False)
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


# fluid.layers.io surface (reader builders; see layers/io.py)
from paddle_tpu_torch.layers import io  # noqa: E402
from paddle_tpu_torch.layers.io import (  # noqa: E402,F401
    Preprocessor, batch, create_py_reader_by_data, double_buffer, load,
    open_files, py_reader, random_data_generator, read_file, shuffle,
)
