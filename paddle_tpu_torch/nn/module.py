"""Parameter collection for the eager path: the port of
``paddle_tpu/nn/module.py``.

Implicit-context functional modules: during ``init`` / ``apply`` a frame
holds the parameter and state dicts keyed by slash-joined scope names
(``fc_0/w``). Layer code calls ``create_parameter`` imperatively; the frame
makes it pure. The keys are the JAX package's, so the JAX ``init``'s dict
carries across (``params_from_numpy``).

The frame's ``rng`` is a ``torch.Generator``: ``init`` draws the
parameters from it (initializers draw on the CPU: a CUDA generator gives
its seed to a CPU one) and makes them on its device, the card when it is
None. ``apply`` hands it to the layers that draw (``current_rng``).

Inside ``framework.no_grad()`` a Layer's outputs are detached (the JAX
package's ``stop_gradient`` on them), so a parameter used only there gets
exact-zero gradients; the math between layers stays differentiable.

One departure, a refusal: where a parameter of the frame is asked for
again with another shape, ``create_parameter`` raises naming it. The JAX
package returns the first one whatever the shape (a second ``fc_w`` of
another width is silently the first one; ROADMAP queue 3 note h).
"""

import contextlib
import threading

import numpy as np
import torch

from paddle_tpu_torch import initializer as I
from paddle_tpu_torch.core.dtypes import convert_dtype
from paddle_tpu_torch.core.enforce import EnforceNotMet

__all__ = ["Layer", "Sequential", "LayerList", "transform",
           "create_parameter", "create_state", "get_state", "set_state",
           "in_module_ctx", "current_rng", "params_from_numpy"]

_tls = threading.local()


def _frames():
    if not hasattr(_tls, "stack"):
        _tls.stack = []
    return _tls.stack


class _Frame:
    def __init__(self, mode, params=None, state=None, rng=None):
        self.mode = mode                      # "init" | "apply"
        self.params = dict(params or {})
        self.state = dict(state or {})
        self.rng = rng
        self.name_stack = []
        self._name_counts = [{}]
        self._draws = None

    @property
    def device(self):
        """Where ``init`` makes parameters and state: the generator's
        device, or the card without one."""
        if self.rng is not None:
            return self.rng.device
        from paddle_tpu_torch import default_device
        return default_device()

    def scoped_name(self, name):
        return "/".join(self.name_stack + [name])

    def next_rng(self):
        """The CPU generator initializers draw from: the frame's own when
        it is a CPU one, else one seeded from its seed (or torch's default
        CPU generator without one)."""
        if self._draws is None:
            if self.rng is None:
                self._draws = torch.default_generator
            elif self.rng.device.type == "cpu":
                self._draws = self.rng
            else:
                self._draws = torch.Generator().manual_seed(
                    self.rng.initial_seed())
        return self._draws

    @contextlib.contextmanager
    def scope(self, name):
        counts = self._name_counts[-1]
        n = counts.get(name, 0)
        counts[name] = n + 1
        self.name_stack.append(f"{name}_{n}" if n else name)
        self._name_counts.append({})
        try:
            yield
        finally:
            self.name_stack.pop()
            self._name_counts.pop()


def in_module_ctx():
    return bool(_frames())


def _frame():
    if not _frames():
        raise EnforceNotMet(
            "create_parameter called outside a module context — call the "
            "layer through .init()/.apply() or inside nn.transform")
    return _frames()[-1]


def current_rng():
    """The frame's generator (None when ``apply`` was given none)."""
    return _frame().rng


def _check_shape(kind, full, have, shape):
    if tuple(have.shape) != tuple(shape):
        raise EnforceNotMet(
            f"{kind} {full!r} exists with shape {list(have.shape)} and is "
            f"asked for again with shape {list(shape)}: two layers share "
            f"its name; give each its own (ParamAttr(name=...) or a Layer "
            f"scope)")


def create_parameter(name, shape, dtype=torch.float32, initializer=None,
                     attr=None):
    """Create (at ``init``) or fetch (at ``apply``) a parameter of the
    current frame. ``attr`` is a ParamAttr: its initializer and name
    override the defaults (param_attr.py parity)."""
    from paddle_tpu_torch.framework import ParamAttr
    attr = ParamAttr.to_attr(attr) if attr is not None else None
    if attr is None and isinstance(initializer, ParamAttr):
        attr, initializer = initializer, None
    if attr is not None:
        if attr.initializer is not None:
            initializer = attr.initializer
        if attr.name:
            name = attr.name
    initializer = initializer or I.Xavier()
    f = _frame()
    full = f.scoped_name(name)
    if full not in f.params:
        if f.mode != "init":
            raise EnforceNotMet(
                f"Parameter {full!r} missing at apply time — params dict "
                f"doesn't match the module structure")
        f.params[full] = initializer(f.next_rng(), tuple(shape),
                                     convert_dtype(dtype)).to(f.device)
    else:
        _check_shape("Parameter", full, f.params[full], shape)
    return f.params[full]


def create_state(name, shape, dtype=torch.float32, init_value=0.0):
    """Non-trainable carried state (batch norm's running stats: the
    reference's persistable vars that are not Parameters)."""
    f = _frame()
    full = f.scoped_name(name)
    if full not in f.state:
        if f.mode != "init":
            raise EnforceNotMet(f"State {full!r} missing at apply time")
        f.state[full] = torch.full(tuple(shape), init_value,
                                   dtype=convert_dtype(dtype),
                                   device=f.device)
    else:
        _check_shape("State", full, f.state[full], shape)
    return f.state[full]


def get_state(name):
    f = _frame()
    return f.state.get(f.scoped_name(name))


def set_state(name, value):
    f = _frame()
    f.state[f.scoped_name(name)] = value


def _run(mode, fn, params, state, rng, args, kwargs):
    f = _Frame(mode, params=params, state=state, rng=rng)
    _frames().append(f)
    try:
        out = fn(*args, **kwargs)
    finally:
        _frames().pop()
    return f, out


class Layer:
    """dygraph.Layer parity: subclass and implement forward()."""

    def __init__(self, name_scope=None):
        self._scope_name = name_scope or type(self).__name__.lower()
        self._sublayers = {}

    def __setattr__(self, k, v):
        if isinstance(v, Layer):
            self.__dict__.setdefault("_sublayers", {})[k] = v
        super().__setattr__(k, v)

    def forward(self, *args, **kwargs):
        raise NotImplementedError

    def __call__(self, *args, **kwargs):
        if not in_module_ctx():
            raise EnforceNotMet(
                f"{type(self).__name__} called outside a module context — "
                f"use .init(rng, ...) then .apply(params, state, ...)")
        with _frame().scope(self._scope_name):
            out = self.forward(*args, **kwargs)
        from paddle_tpu_torch.framework import in_no_grad, stop_gradient
        if in_no_grad():
            out = stop_gradient(out)
        return out

    # -- functional entry points ------------------------------------------
    def init(self, rng, *args, **kwargs):
        """Returns (params, state), on ``rng``'s device (the card when
        None)."""
        f, _ = _run("init", self, None, None, rng, args, kwargs)
        return f.params, f.state

    def apply(self, params, state, rng, *args, **kwargs):
        """Returns (out, new_state)."""
        f, out = _run("apply", self, params, state, rng, args, kwargs)
        return out, f.state

    def sublayers(self):
        return list(self._sublayers.values())


class Sequential(Layer):
    def __init__(self, *layers):
        super().__init__()
        self._layers = []
        for i, l in enumerate(layers):
            setattr(self, f"l{i}", l)
            self._layers.append(l)

    def forward(self, x):
        for l in self._layers:
            x = l(x)
        return x


class LayerList(Layer):
    def __init__(self, layers=()):
        super().__init__()
        self._layers = []
        for i, l in enumerate(layers):
            setattr(self, f"l{i}", l)
            self._layers.append(l)

    def append(self, l):
        setattr(self, f"l{len(self._layers)}", l)
        self._layers.append(l)

    def __iter__(self):
        return iter(self._layers)

    def __getitem__(self, i):
        return self._layers[i]

    def __len__(self):
        return len(self._layers)

    def forward(self, *a, **k):
        raise EnforceNotMet("LayerList is a container; call its members")


def transform(fn):
    """haiku-style: a function that uses create_parameter as an (init,
    apply) pair: ``init(rng, *args) -> (params, state)``, ``apply(params,
    state, rng, *args) -> (out, new_state)``."""
    class _T:
        @staticmethod
        def init(rng, *args, **kwargs):
            f, _ = _run("init", fn, None, None, rng, args, kwargs)
            return f.params, f.state

        @staticmethod
        def apply(params, state, rng, *args, **kwargs):
            f, out = _run("apply", fn, params, state, rng, args, kwargs)
            return out, f.state

    return _T()


def params_from_numpy(tree, device=None):
    """A tree of numpy arrays (the JAX ``init``'s dict, as
    ``jax.tree.map(np.asarray, params)`` gives it; nested dicts and lists
    too) as tensors on ``device`` (the card when None), keys kept."""
    from paddle_tpu_torch import resolve_device
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        return torch.from_numpy(np.array(x)).to(dev)

    return conv(tree)
