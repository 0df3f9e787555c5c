"""Optimizers: the port of ``paddle_tpu/optimizer.py``'s SGD, Momentum and
Adam, on both of its paths.

- **functional**: ``state = opt.init(params)`` then
  ``opt.apply_gradients(params, grads, state)``, with params, grads and
  slots as nested dicts and lists of tensors. Where the JAX package returns
  new arrays (and donates the old ones), the port updates params, slots and
  the step counter **in place** and returns the same trees: one launch of
  the rule's kernel (``fused_sgd``, ``fused_momentum``, ``fused_adam``) over
  the whole parameter list per step on the card, its plain PyTorch version
  on the CPU.
- **static**: ``opt.minimize(loss)`` appends the ``autodiff`` op, an
  ``increment_step`` op and one ``apply_optimizer`` op per parameter to the
  Program (optimizer.py:127-221). The Executor runs each ``apply_optimizer``
  as one launch over its one parameter, in place, as the JAX package runs
  one Pallas call per parameter.

The kernels take fp32 parameters, grads and slots, where the output dtype
the JAX package pins by ``eval_shape`` (optimizer.py:255-261) is fp32 as
well; another dtype raises. A callable learning rate (a schedule),
``regularization`` and ``grad_clip`` raise :class:`EnforceNotMet` naming the
ROADMAP item that ports them.
"""

import numpy as np
import torch

from paddle_tpu_torch import initializer as I
from paddle_tpu_torch.core.dtypes import dtype_name
from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.core.tree import leaves, map_tree
from paddle_tpu_torch.ops.kernels import fused_adam, fused_momentum, fused_sgd
from paddle_tpu_torch.static.program import (
    default_startup_program, in_static_mode, register_op,
)

__all__ = ["Optimizer", "AdamOptimizer", "Adam", "SGDOptimizer", "SGD",
           "MomentumOptimizer", "Momentum"]


class Optimizer:
    """Base of the update rules: the functional path of
    ``paddle_tpu.optimizer.Optimizer`` (init / apply_gradients / step).
    A subclass names its slots in ``_slot_defaults`` and updates the flat
    lists in ``_apply``."""

    _slot_defaults = {}       # slot name -> initial value

    def __init__(self, learning_rate=0.001, regularization=None,
                 grad_clip=None, name=None):
        if callable(learning_rate):
            raise EnforceNotMet(
                "a learning-rate schedule is not ported yet (ROADMAP queue 1 "
                "item 5, with layers/learning_rate_scheduler.py): pass a "
                "float")
        if regularization is not None or grad_clip is not None:
            raise EnforceNotMet(
                "regularization and grad_clip are not ported yet (ROADMAP "
                "queue 1 item 7: regularizer.py, clip.py)")
        self.learning_rate = float(learning_rate)
        self.name = name

    def init(self, params):
        """{"step": 0-d int32 tensor on the params' device, "slots": a tree
        like params of {slot name: fp32 tensor like the param}}."""
        flat = leaves(params)
        if not flat:
            raise EnforceNotMet("init: params has no tensors")
        return {
            "step": torch.zeros((), dtype=torch.int32, device=flat[0].device),
            "slots": map_tree(lambda _, p: {
                k: torch.full_like(p, v) for k, v in
                self._slot_defaults.items()}, params),
        }

    def apply_gradients(self, params, grads, state):
        """One update, **in place**: params, the slots of ``state`` and its
        step counter are overwritten, and ``(params, state)`` (the same
        objects) are returned. ``grads`` is a tree like params; the trees
        are matched by key, not by order."""
        rows = leaves(map_tree(
            lambda path, p, g, s: (p, _grad(path, p, g), s),
            params, grads, state["slots"]))
        state["step"].add_(1)
        with torch.no_grad():
            self._apply([p for p, _, _ in rows], [g for _, g, _ in rows],
                        [[s[k] for _, _, s in rows]
                         for k in self._slot_defaults], state["step"])
        return params, state

    def step(self, params, grads, state=None):
        """One-call functional step: ``init`` first when ``state`` is None."""
        if state is None:
            state = self.init(params)
        return self.apply_gradients(params, grads, state)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        """Append the backward and the update ops to ``loss``'s program and
        the slots' and step counter's initializers to the startup program
        (optimizer.py:127-221). Returns ``(update ops, [(param, grad)])``."""
        from paddle_tpu_torch.static.backward import append_backward
        if not in_static_mode():
            raise EnforceNotMet(
                "minimize() is the static-graph API; in eager mode use "
                "apply_gradients(params, grads, state)")
        program = loss.block.program
        blk = program.global_block()
        p_g = append_backward(loss, parameter_list, no_grad_set)
        for p, _ in p_g:
            if p.regularizer is not None or p.gradient_clip is not None:
                raise EnforceNotMet(
                    f"parameter {p.name!r}: a per-parameter regularizer or "
                    "gradient clip is not ported yet (ROADMAP queue 1 item "
                    "7: regularizer.py, clip.py)")
        sblk = (startup_program or default_startup_program()).global_block()

        step_name = f"@opt@{self.name or type(self).__name__}@step"
        if not blk.has_var(step_name):
            blk.create_var(name=step_name, shape=(), dtype=torch.int32,
                           persistable=True)
            sblk.create_var(name=step_name, shape=(), dtype=torch.int32,
                            persistable=True)
            sblk.append_op(type="init_param", inputs={},
                           outputs={"Out": [step_name]},
                           attrs={"initializer": I.Constant(0), "shape": (),
                                  "dtype": "int32"})
        blk.append_op(type="increment_step", inputs={"X": [step_name]},
                      outputs={"Out": [step_name]}, attrs={})

        ops = []
        for p, g in p_g:
            slot_names = []
            for sname, sval in self._slot_defaults.items():
                full = f"{p.name}@{sname}"
                slot_names.append(full)
                if not blk.has_var(full):
                    blk.create_var(name=full, shape=p.shape, dtype=p.dtype,
                                   persistable=True)
                    sblk.create_var(name=full, shape=p.shape, dtype=p.dtype,
                                    persistable=True)
                    sblk.append_op(
                        type="init_param", inputs={},
                        outputs={"Out": [full]},
                        attrs={"initializer": I.Constant(sval),
                               "shape": tuple(int(s) if s not in (None, -1)
                                              else 1 for s in p.shape),
                               "dtype": dtype_name(p.dtype)})
            ops.append(blk.append_op(
                type="apply_optimizer",
                inputs={"Param": [p.name], "Grad": [g.name],
                        "Slots": slot_names, "Step": [step_name]},
                outputs={"ParamOut": [p.name], "SlotOuts": slot_names},
                attrs={"opt": self, "slot_names": list(self._slot_defaults),
                       "param_lr": p.optimize_attr.get("learning_rate",
                                                       1.0)}))
        return ops, p_g

    def state_from_numpy(self, tree, params):
        """The port's optimizer state from the JAX package's, after
        ``jax.tree.map(np.asarray, opt_state)``, on the device of
        ``params``. Strict: ``step`` must be an int32 0-d array, and the
        slots a tree like params whose leaves are dicts of exactly this
        optimizer's slot names, each a float32 array of its param's shape;
        anything else raises."""
        if not isinstance(tree, dict) or set(tree) != {"step", "slots"}:
            got = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise EnforceNotMet("state_from_numpy: expected a dict with keys "
                                f"['slots', 'step'], got {got}")
        step = tree["step"]
        if (not isinstance(step, np.ndarray) or step.dtype != np.int32
                or step.shape != ()):
            raise EnforceNotMet(
                "state_from_numpy: step must be a 0-d int32 numpy array, got "
                f"{getattr(step, 'dtype', type(step).__name__)}"
                f"{list(getattr(step, 'shape', []))}")

        def slot(path, p, s):
            if not isinstance(s, dict) or set(s) != set(self._slot_defaults):
                got = sorted(s) if isinstance(s, dict) else type(s).__name__
                raise EnforceNotMet(
                    f"state_from_numpy: slots.{path} must be a dict with keys "
                    f"{sorted(self._slot_defaults)}, got {got}")
            out = {}
            for k, a in s.items():
                if (not isinstance(a, np.ndarray) or a.dtype != np.float32
                        or a.shape != tuple(p.shape)):
                    got = (f"{a.dtype}{list(a.shape)}"
                           if isinstance(a, np.ndarray) else type(a).__name__)
                    raise EnforceNotMet(
                        f"state_from_numpy: slots.{path}.{k} must be a "
                        f"float32 numpy array of shape {list(p.shape)}, got "
                        f"{got}")
                out[k] = torch.tensor(a).to(p.device)
            return out

        slots = map_tree(slot, params, tree["slots"])
        dev = leaves(params)[0].device
        return {"step": torch.tensor(step).to(dev), "slots": slots}

    def _apply(self, params, grads, slots, step):
        raise NotImplementedError


def _grad(path, p, g):
    if not isinstance(g, torch.Tensor) or g.shape != p.shape:
        got = tuple(g.shape) if isinstance(g, torch.Tensor) else type(g)
        raise EnforceNotMet(f"apply_gradients: the grad of {path} must be a "
                            f"tensor of shape {tuple(p.shape)}, got {got}")
    return g


class AdamOptimizer(Optimizer):
    """adam_op.cc, bias-corrected, as ``paddle_tpu.optimizer.AdamOptimizer``:
    eps sits on sqrt(m2) *before* the bias correction, so this is not
    ``torch.optim.Adam``'s rule. fp32 params and slots."""

    _slot_defaults = {"moment1": 0.0, "moment2": 0.0}

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kw):
        super().__init__(learning_rate, **kw)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _apply(self, params, grads, slots, step):
        m1s, m2s = slots
        fused_adam(params, grads, m1s, m2s, self.learning_rate, step,
                   beta1=self.beta1, beta2=self.beta2, epsilon=self.epsilon)


class SGDOptimizer(Optimizer):
    """sgd_op.cc: p -= lr * g. fp32 params."""

    def _apply(self, params, grads, slots, step):
        fused_sgd(params, grads, self.learning_rate)


class MomentumOptimizer(Optimizer):
    """momentum_op.cc: v = momentum * v + g, then p -= lr * v, or
    p -= lr * (g + momentum * v) with ``use_nesterov``. fp32 params."""

    _slot_defaults = {"velocity": 0.0}

    def __init__(self, learning_rate, momentum=0.9, use_nesterov=False,
                 **kw):
        super().__init__(learning_rate, **kw)
        self.momentum = momentum
        self.use_nesterov = use_nesterov

    def _apply(self, params, grads, slots, step):
        (velocities,) = slots
        fused_momentum(params, grads, velocities, self.learning_rate,
                       momentum=self.momentum,
                       use_nesterov=self.use_nesterov)


def _fused_update(opt, p, g, slots, lr, step):
    """One launch of the rule's kernel over the one parameter ``p``, in
    place (the counterpart of ``_pallas_fused_update``,
    optimizer.py:224-261). The stock rule's output dtype, which the JAX
    package pins by ``eval_shape``, is fp32 for fp32 inputs; the kernels
    take nothing else."""
    for nm, t in (("param", p), ("grad", g), *slots.items()):
        if t.dtype != torch.float32:
            raise EnforceNotMet(
                f"apply_optimizer: the fused {type(opt).__name__} update "
                f"takes float32 tensors, got {nm} {t.dtype}")
    if isinstance(opt, AdamOptimizer):
        fused_adam([p], [g], [slots["moment1"]], [slots["moment2"]], lr,
                   step, beta1=opt.beta1, beta2=opt.beta2,
                   epsilon=opt.epsilon)
    elif isinstance(opt, MomentumOptimizer):
        fused_momentum([p], [g], [slots["velocity"]], lr,
                       momentum=opt.momentum, use_nesterov=opt.use_nesterov)
    elif isinstance(opt, SGDOptimizer):
        fused_sgd([p], [g], lr)
    else:
        raise EnforceNotMet(f"{type(opt).__name__} has no fused update")


def _apply_optimizer_compute(ins, attrs):
    """The static ``apply_optimizer`` op (optimizer.py:264-277): updates
    Param and Slots in place and returns them as ParamOut and SlotOuts. The
    learning rate is the fp32 product of the optimizer's and the
    parameter's, as the JAX op computes it."""
    opt = attrs["opt"]
    p, g, step = ins["Param"][0], ins["Grad"][0], ins["Step"][0]
    slots = dict(zip(attrs["slot_names"], ins.get("Slots", [])))
    lr = float(np.float32(opt.learning_rate)
               * np.float32(attrs.get("param_lr", 1.0)))
    with torch.no_grad():
        _fused_update(opt, p, g, slots, lr, step)
    return {"ParamOut": [p],
            "SlotOuts": [slots[k] for k in attrs["slot_names"]]}


register_op("apply_optimizer", _apply_optimizer_compute)
register_op("increment_step", lambda ins, attrs: {"Out": [ins["X"][0] + 1]})


Adam = AdamOptimizer
SGD = SGDOptimizer
Momentum = MomentumOptimizer
