"""Framework helpers: the port of ``paddle_tpu/framework.py``.

``unique_name`` advances its counters exactly as the JAX package's does
(``fc_w``, ``fc_w_1``, ...), so one script names its parameters alike in both
packages and weights carry across by name.

The dygraph helpers: ``to_variable`` (host data as a tensor on the card, or
on ``device``), ``no_grad`` (inside it every ``nn.Layer``'s outputs are
detached; the decorator form detaches the function's outputs),
``stop_gradient`` and ``grad``, the ``jax.grad`` of the JAX package over a
tree of tensors, built on ``torch.autograd.grad``: each differentiated
argument's tensors are detached into new leaves that require grad, the
function runs with autograd on, and a leaf the result does not reach gets
zeros, as ``jax.grad`` gives. The result must be a 0-d floating tensor.
"""

import contextlib
import functools
import threading

import numpy as np
import torch

from paddle_tpu_torch.core.tree import map_tensors

__all__ = ["unique_name", "ParamAttr", "WeightNormParamAttr", "Variable",
           "to_variable", "no_grad", "grad", "stop_gradient"]


class _UniqueNameGenerator:
    """python/paddle/fluid/unique_name.py parity."""

    def __init__(self):
        self.ids = {}

    def __call__(self, prefix):
        n = self.ids.get(prefix, 0)
        self.ids[prefix] = n + 1
        return f"{prefix}_{n}" if n else prefix


class _UniqueNameModule:
    def __init__(self):
        self._gen = _UniqueNameGenerator()

    def generate(self, prefix):
        return self._gen(prefix)

    @contextlib.contextmanager
    def guard(self):
        old = self._gen
        self._gen = _UniqueNameGenerator()
        try:
            yield
        finally:
            self._gen = old


unique_name = _UniqueNameModule()


class ParamAttr:
    """python/paddle/fluid/param_attr.py parity."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, gradient_clip=None,
                 do_model_average=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip
        self.do_model_average = do_model_average

    @staticmethod
    def to_attr(arg):
        if arg is None:
            return ParamAttr()
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if arg is False:
            return None
        # an initializer instance
        return ParamAttr(initializer=arg)


class WeightNormParamAttr(ParamAttr):
    """param_attr.py WeightNormParamAttr parity: the parameter becomes
    ``g * v / ||v||`` with the norm over every axis but ``dim`` (all axes
    when None), ``g`` starting at the norm of ``v``'s initial value."""

    def __init__(self, dim=None, **kwargs):
        super().__init__(**kwargs)
        self.dim = dim


def to_variable(value, name=None, zero_copy=None, device=None):
    """dygraph.to_variable parity: host data as a tensor on ``device`` (the
    card when None); a tensor is returned as it is."""
    if isinstance(value, torch.Tensor):
        return value
    from paddle_tpu_torch import resolve_device
    return torch.as_tensor(np.asarray(value)).to(resolve_device(device))


_no_grad_state = threading.local()


def in_no_grad():
    """True inside a ``no_grad()`` region (thread-local)."""
    return getattr(_no_grad_state, "depth", 0) > 0


class _NoGrad:
    """dygraph.no_grad parity, as the JAX package means it: inside the
    region every ``nn.Layer`` call detaches its outputs, so a parameter
    used only there gets exactly-zero gradients from :func:`grad`. It is
    not ``torch.no_grad()``: math between layers stays differentiable.
    A context manager and a decorator (which detaches the function's
    outputs)."""

    def __enter__(self):
        _no_grad_state.depth = getattr(_no_grad_state, "depth", 0) + 1
        return self

    def __exit__(self, *exc):
        _no_grad_state.depth -= 1
        return False

    def __call__(self, fn=None):
        if fn is None:           # ``with no_grad():`` form
            return self

        @functools.wraps(fn)     # ``@no_grad`` decorator form
        def inner(*a, **k):
            with self:
                return map_tensors(torch.Tensor.detach, fn(*a, **k))
        return inner


no_grad = _NoGrad()


def stop_gradient(x):
    """The tensors of ``x`` (a tensor or a tree) detached."""
    return map_tensors(torch.Tensor.detach, x)


def _leaves_of(tree, out):
    """``tree`` with each tensor replaced by a detached leaf that requires
    grad (appended to ``out``)."""
    def leaf(t):
        if not (t.is_floating_point() or t.is_complex()):
            raise TypeError(
                "grad requires real- or complex-valued inputs (input dtype "
                f"that is a sub-dtype of np.inexact), but got {t.dtype}")
        x = t.detach().requires_grad_()
        out.append(x)
        return x
    return map_tensors(leaf, tree)


def grad(fn, argnums=0, has_aux=False):
    """``jax.grad`` parity: a function of ``fn``'s arguments that returns
    the gradient of ``fn``'s 0-d result with respect to the argument(s)
    ``argnums`` (an int, or a tuple giving a tuple), each a tree like its
    argument; with ``has_aux``, ``fn`` returns ``(result, aux)`` and the
    function ``(grads, aux)``, aux detached. Built on
    ``torch.autograd.grad``, so the kernels' autograd Functions take part;
    a tensor the result does not reach gets zeros."""
    nums = (argnums,) if isinstance(argnums, int) else tuple(argnums)

    def grad_fn(*args, **kwargs):
        args = list(args)
        per_arg = []
        for i in nums:
            flat = []
            args[i] = _leaves_of(args[i], flat)
            per_arg.append(flat)
        with torch.enable_grad():
            out = fn(*args, **kwargs)
            loss, aux = out if has_aux else (out, None)
            if not isinstance(loss, torch.Tensor) or loss.dim() != 0:
                shape = tuple(getattr(loss, "shape", ()))
                raise TypeError(
                    "Gradient only defined for scalar-output functions. "
                    f"Output had shape: {shape}.")
            if not loss.is_floating_point():
                raise TypeError("grad requires real-valued outputs (output "
                                f"dtype that is a sub-dtype of np.floating), "
                                f"but got {loss.dtype}")
            flat = [x for f in per_arg for x in f]
            gs = torch.autograd.grad(loss, flat, allow_unused=True) \
                if loss.requires_grad else [None] * len(flat)
        it = iter(torch.zeros_like(x) if g is None else g
                  for x, g in zip(flat, gs))
        res = tuple(map_tensors(lambda _: next(it), args[i]) for i in nums)
        res = res[0] if isinstance(argnums, int) else res
        return (res, stop_gradient(aux)) if has_aux else res

    return grad_fn


# Variable is the static-graph symbolic tensor, defined in static.program
# and re-exported here for fluid.framework parity
from paddle_tpu_torch.static.program import Variable  # noqa: E402
