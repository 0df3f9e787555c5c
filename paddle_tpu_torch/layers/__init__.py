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

This slice ports ``fc``, ``embedding`` and the ops they and the word2vec and
fit-a-line programs use: ``mul``, ``matmul``, ``elementwise_add``, ``relu``,
``sigmoid``, ``tanh``, ``gelu``, ``softmax``, ``cross_entropy``,
``square_error_cost``, ``mean``, ``concat`` and ``reshape`` (the rest of the
op library is ROADMAP queue 1 item 4).
"""

import functools
import inspect

import torch

from paddle_tpu_torch import initializer as I
from paddle_tpu_torch.core.dtypes import convert_dtype, dtype_name
from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.framework import ParamAttr, unique_name
from paddle_tpu_torch.ops import activation as _act
from paddle_tpu_torch.ops import loss as _loss
from paddle_tpu_torch.ops import math as _math
from paddle_tpu_torch.ops import nn as _nn
from paddle_tpu_torch.ops import reduce as _reduce
from paddle_tpu_torch.ops import tensor_ops as _tensor
from paddle_tpu_torch.static.program import (
    Variable, default_main_program, default_startup_program,
    in_static_mode, data, register_op,
)

__all__ = ["data", "fc", "embedding", "mul", "matmul",
           "elementwise_add", "relu", "sigmoid", "tanh", "gelu", "softmax",
           "cross_entropy", "square_error_cost", "mean", "concat",
           "reshape"]

#: ops whose leading N args are tensors (default 1)
_NARGS = {"elementwise_add": 2, "matmul": 2, "mul": 2, "cross_entropy": 2,
          "square_error_cost": 2, "embedding": 2}
#: ops whose first arg is a list of tensors
_LIST_FIRST = {"concat"}
#: ops whose compute reaches a kernel: shape inference runs this plain body
_SHAPE_BODIES = {"embedding": _nn.embedding_reference}
_META = torch.device("meta")
#: op name -> its op function (the eager body of its layer)
_OPS = {}


def _register(name, fn):
    """Register ``fn`` as op ``name``: inputs ride the "X" slot."""
    listy = name in _LIST_FIRST
    _OPS[name] = fn

    def compute(ins, attrs):
        xs = ins.get("X", [])
        out = fn(list(xs), **attrs) if listy else fn(*xs, **attrs)
        return {"Out": list(out) if isinstance(out, tuple) else [out]}

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


def _append_static(name, tensor_vals, attrs, listy):
    """Append one op to the current program; returns its output Variable.
    A literal (non-Variable) operand becomes a program constant."""
    program = default_main_program()
    blk = program.global_block()
    fn = _SHAPE_BODIES.get(name, _OPS[name])
    in_names, probes2, probes3 = [], [], []
    had_dyn = False
    for tv in (tensor_vals[0] if listy else tensor_vals):
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

    def infer(xs):
        return fn(list(xs), **attrs) if listy else fn(*xs, **attrs)

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
    shape, dtype = None, torch.float32
    if out2 is not None:
        dtype = out2.dtype
        shape = [d if out3 is None or d == out3.shape[j] else -1
                 for j, d in enumerate(out2.shape)]
        if out3 is None and had_dyn and shape and shape[0] == 2:
            shape[0] = -1
    v = blk.create_var(name=unique_name.generate(f"{name}.out"),
                       shape=shape, dtype=dtype)
    if shape is None:
        v._shape_error = shape_error
    blk.append_op(type=name, inputs={"X": in_names},
                  outputs={"Out": [v.name]}, attrs=dict(attrs))
    return v


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
        attrs = {p: vals[p] for p in attr_names if p in vals and p != "name"}
        if in_static_mode() and _has_variable(
                tensor_vals[0] if listy else tensor_vals):
            if any(isinstance(v, Variable) for v in attrs.values()):
                raise EnforceNotMet(
                    f"{name}: a Variable in an attribute position is not "
                    "ported yet (ROADMAP queue 1 item 4)")
            return _append_static(name, tensor_vals, attrs, listy)
        return fn(*args, **kwargs)

    return wrapper


mul = _dual("mul", _math.mul)
matmul = _dual("matmul", _math.matmul)
elementwise_add = _dual("elementwise_add", _math.elementwise_add)
relu = _dual("relu", _act.relu)
sigmoid = _dual("sigmoid", _act.sigmoid)
tanh = _dual("tanh", _act.tanh)
gelu = _dual("gelu", _act.gelu)
softmax = _dual("softmax", _act.softmax)
cross_entropy = _dual("cross_entropy", _loss.cross_entropy)
square_error_cost = _dual("square_error_cost", _loss.square_error_cost)
mean = _dual("mean", _reduce.mean)
concat = _dual("concat", _tensor.concat)
reshape = _dual("reshape", _tensor.reshape)
_register("embedding", _nn.embedding)


# ---------------------------------------------------------------------------
# parameterized layers
# ---------------------------------------------------------------------------
def _make_param(prefix, shape, dtype, attr, default_init):
    """Create a parameter in the current program, and its ``init_param``
    op in the startup program (once per name)."""
    attr = ParamAttr.to_attr(attr) if attr is not None else ParamAttr()
    init = attr.initializer or default_init
    if not in_static_mode():
        raise EnforceNotMet(
            "a parameterized layer needs a Program (enable_static or "
            "program_guard); the eager module context is not ported yet "
            "(ROADMAP queue 1 item 7)")
    blk = default_main_program().global_block()
    name = attr.name or unique_name.generate(prefix)
    p = blk.create_parameter(
        name, shape, dtype, trainable=attr.trainable,
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


_ACTS = {"relu": relu, "sigmoid": sigmoid, "tanh": tanh, "gelu": gelu,
         "softmax": softmax}


def _apply_act(x, act):
    if act is None:
        return x
    if act not in _ACTS:
        raise EnforceNotMet(f"activation {act!r} is not ported yet (ROADMAP "
                            f"queue 1 item 4); ported: {sorted(_ACTS)}")
    return _ACTS[act](x)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    """fluid.layers.embedding / lookup_table parity. ``is_sparse`` and
    ``is_distributed`` are advisory, as in the JAX package."""
    w = _make_param("emb_w", tuple(size), convert_dtype(dtype), param_attr,
                    I.Xavier())
    pi = padding_idx if padding_idx is None or padding_idx >= 0 \
        else size[0] + padding_idx
    return _append_static("embedding", [input, w], {"padding_idx": pi},
                          False)
