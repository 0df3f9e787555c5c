"""Program IR: Program / Block / Operator / Variable.

The port of ``paddle_tpu/static/program.py`` (framework.proto's
ProgramDesc{BlockDesc{OpDesc, VarDesc}}). An Operator carries (type, input
slots, output slots, attrs); its meaning is ``OP_REGISTRY[type]``, a function
over torch tensors ``fn(ins, attrs) -> outs`` with ``{slot: [tensor, ...]}``
on both sides. The Executor (``static/executor.py``) interprets the ops in
order through it.
"""

import contextlib
import copy
import threading

from paddle_tpu_torch.core.dtypes import convert_dtype, dtype_name
from paddle_tpu_torch.core.enforce import EnforceNotMet, enforce

__all__ = ["OP_REGISTRY", "register_op", "Variable", "Parameter",
           "Operator", "Block", "Program", "default_main_program",
           "default_startup_program", "program_guard", "in_static_mode",
           "enable_static", "disable_static", "static_mode_guard",
           "name_scope", "data"]

#: op type -> fn(ins: {slot: [tensor]}, attrs: dict) -> {slot: [tensor]}
OP_REGISTRY = {}


def register_op(type_name, fn=None):
    """Register an op compute function (as a decorator or directly)."""
    def deco(f):
        OP_REGISTRY[type_name] = f
        return f
    if fn is not None:
        return deco(fn)
    return deco


class Variable:
    """Symbolic tensor in a Block (VarDesc parity). ``shape`` holds -1 for
    a dynamic dim; ``dtype`` is a torch dtype."""

    def __init__(self, block, name, shape=None, dtype="float32",
                 persistable=False, stop_gradient=False, is_data=False,
                 lod_level=0):
        self.block = block
        self.name = name
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = convert_dtype(dtype)
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.lod_level = lod_level

    @property
    def program(self):
        return self.block.program

    def __repr__(self):
        return (f"Variable(name={self.name}, shape={self.shape}, "
                f"dtype={dtype_name(self.dtype)})")

    # arithmetic sugar (framework.py monkey-patches these on Variable)
    def _binary(self, other, op_type):
        from paddle_tpu_torch import layers
        return getattr(layers, op_type)(self, other)

    def __add__(self, other):
        return self._binary(other, "elementwise_add")

    def __sub__(self, other):
        return self._binary(other, "elementwise_sub")

    def __mul__(self, other):
        return self._binary(other, "elementwise_mul")

    def __truediv__(self, other):
        return self._binary(other, "elementwise_div")


class Parameter(Variable):
    """Persistable, trainable variable with its optimizer attributes."""

    def __init__(self, block, name, shape, dtype="float32", trainable=True,
                 optimize_attr=None, regularizer=None, gradient_clip=None,
                 do_model_average=True, initializer=None):
        super().__init__(block, name, shape, dtype, persistable=True)
        self.trainable = trainable
        self.optimize_attr = optimize_attr or {"learning_rate": 1.0}
        self.regularizer = regularizer
        self.gradient_clip = gradient_clip
        self.do_model_average = do_model_average
        self.initializer = initializer


def _names(vs):
    return [v if isinstance(v, str) else v.name
            for v in (vs if isinstance(vs, (list, tuple)) else [vs])]


class Operator:
    """OpDesc parity: (type, inputs, outputs, attrs), slots by var name."""

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None):
        self.block = block
        self.type = type
        self.inputs = {k: _names(vs) for k, vs in (inputs or {}).items()}
        self.outputs = {k: _names(vs) for k, vs in (outputs or {}).items()}
        self.attrs = dict(attrs or {})

    def input_names(self):
        return [n for vs in self.inputs.values() for n in vs]

    def output_names(self):
        return [n for vs in self.outputs.values() for n in vs]

    def __repr__(self):
        return f"{{Op({self.type}): in={self.inputs} out={self.outputs}}}"


class Block:
    """BlockDesc parity: ordered ops and a var table."""

    def __init__(self, program, idx=0, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars = {}
        self.ops = []

    def create_var(self, name=None, shape=None, dtype="float32", **kw):
        from paddle_tpu_torch.framework import unique_name
        name = name or unique_name.generate("tmp")
        v = Variable(self, name, shape, dtype, **kw)
        self.vars[name] = v
        return v

    def create_parameter(self, name, shape, dtype="float32", **kw):
        p = Parameter(self, name, shape, dtype, **kw)
        self.vars[name] = p
        return p

    def var(self, name):
        v = self.vars.get(name)
        if v is None:
            raise EnforceNotMet(f"Variable {name!r} not found in block "
                                f"{self.idx}")
        return v

    def has_var(self, name):
        return name in self.vars

    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        enforce(type in OP_REGISTRY or type == "autodiff",
                f"op type {type!r} has no registered compute function")
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.append(op)
        self.program._bump()
        return op

    def all_parameters(self):
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def __repr__(self):
        lines = [f"Block[{self.idx}] vars={len(self.vars)}"]
        lines += [f"  {op!r}" for op in self.ops]
        return "\n".join(lines)


class Program:
    """ProgramDesc parity, with one block. ``_constants`` holds the literal
    (non-Variable) operands captured while building, name -> tensor; the
    Executor seeds each run with them. ``_py_readers`` lists the readers
    (``layers.py_reader`` ...) that feed this program's data vars; a run
    with no feed pulls a batch from each one started."""

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self.random_seed = 0
        self._version = 0
        self._constants = {}
        self._py_readers = []
        # the default clip of minimize(), set by clip.set_gradient_clip
        self._grad_clip = None

    def _bump(self):
        self._version += 1

    @property
    def version(self):
        return self._version

    def current_block(self):
        return self.blocks[0]

    def global_block(self):
        return self.blocks[0]

    def all_parameters(self):
        return self.global_block().all_parameters()

    def list_vars(self):
        return list(self.global_block().vars.values())

    def clone(self, for_test=False):
        """Program.clone parity. ``for_test=True`` sets ``is_test`` on the
        ``dropout`` and ``batch_norm`` ops (``_TEST_MODE_ATTRS``), freezing
        them to their inference behaviour, as the reference rewrites op
        attrs in framework.py's clone."""
        p = Program()
        p.random_seed = self.random_seed
        p._constants = dict(self._constants)
        p._grad_clip = self._grad_clip
        blk = p.global_block()
        blk.vars = {n: copy.copy(v)
                    for n, v in self.global_block().vars.items()}
        for v in blk.vars.values():
            v.block = blk
        for op in self.global_block().ops:
            attrs = dict(op.attrs)
            if for_test and "is_test" in _TEST_MODE_ATTRS.get(op.type, ()):
                attrs["is_test"] = True
            new = Operator(blk, op.type, None, None, attrs)
            new.inputs = {k: list(v) for k, v in op.inputs.items()}
            new.outputs = {k: list(v) for k, v in op.outputs.items()}
            blk.ops.append(new)
        p._bump()
        return p

    def __repr__(self):
        return "\n".join(repr(b) for b in self.blocks)


#: op type -> the attrs ``clone(for_test=True)`` sets
_TEST_MODE_ATTRS = {
    "dropout": ("is_test",),
    "batch_norm": ("is_test",),
}


# ---------------------------------------------------------------------------
# the default programs and the static mode, per thread
# ---------------------------------------------------------------------------
_tls = threading.local()


def _state():
    if not hasattr(_tls, "main"):
        _tls.main = Program()
        _tls.startup = Program()
        _tls.static_mode = False
    return _tls


def default_main_program():
    return _state().main


def default_startup_program():
    return _state().startup


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    st = _state()
    old = (st.main, st.startup, st.static_mode)
    st.main = main_program
    if startup_program is not None:
        st.startup = startup_program
    st.static_mode = True
    try:
        yield
    finally:
        st.main, st.startup, st.static_mode = old


def in_static_mode():
    return _state().static_mode


@contextlib.contextmanager
def static_mode_guard(on=True):
    """Static mode on (or off) inside the block, as it was after."""
    st = _state()
    old = st.static_mode
    st.static_mode = on
    try:
        yield
    finally:
        st.static_mode = old


@contextlib.contextmanager
def name_scope(prefix):
    """fluid.name_scope parity: cosmetic, as in the JAX package."""
    yield


def enable_static():
    """Layer calls append ops to ``default_main_program()`` from now on
    (paddle.enable_static parity)."""
    _state().static_mode = True


def disable_static():
    _state().static_mode = False


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True):
    """fluid.layers.data / fluid.data parity: declare a feed variable.
    ``append_batch_size`` prepends a dynamic batch dim; ``None`` dims
    become -1."""
    shape = [-1 if s is None else int(s) for s in shape]
    if append_batch_size and (not shape or shape[0] != -1):
        shape = [-1] + shape
    blk = default_main_program().global_block()
    return blk.create_var(name=name, shape=shape, dtype=dtype, is_data=True,
                          lod_level=lod_level, stop_gradient=True)
