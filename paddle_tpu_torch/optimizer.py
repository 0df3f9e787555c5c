"""Optimizers: the port of ``paddle_tpu/optimizer.py``'s update rules,
ModelAverage and ExponentialMovingAverage, on both of its paths.

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
well; another dtype raises.

The other rules (LarsMomentum, Adagrad, Adamax, DecayedAdagrad, Adadelta,
RMSProp, Ftrl, ProximalGD, ProximalAdagrad, Lamb; optimizer.py:326-552)
have no Pallas body in the JAX package (pallas/optimizer.py:160-168 registers
only the three above), and here no kernel: they are plain PyTorch ops per
parameter, on the device, written back in place, on both paths. Their rate
is a 0-d fp32 tensor on the parameter's device (``jnp.asarray(lr,
float32)``, optimizer.py:70-74) and ``beta ** t`` is fp32 on the step
counter, so a step makes no host sync.

The learning rate is a float or a schedule
(``layers.learning_rate_scheduler``): a schedule is evaluated in fp32 on the
incremented step counter, on its device, and the kernels read the rate from
device memory, so a scheduled step adds no host sync. ``regularization``
(``regularizer.L2Decay``, ...) and ``grad_clip`` (``clip.Gradient...``)
apply in the JAX package's order: rate, then regularizer, then clip, then
the update (optimizer.py:96-101). The static path takes a parameter's own
regularizer and learning rate from its ``ParamAttr``, and the Program's
clip from ``clip.set_gradient_clip`` as a ``clip_grads`` op; a parameter's
``gradient_clip`` is kept and saved, and applies nowhere, as in the JAX
package.
"""

import numpy as np
import torch

from paddle_tpu_torch import clip as clip_mod
from paddle_tpu_torch import initializer as I
from paddle_tpu_torch.core.dtypes import dtype_name
from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.core.tree import leaves, map_tree
from paddle_tpu_torch.ops.kernels import fused_adam, fused_momentum, fused_sgd
from paddle_tpu_torch.static.program import (
    default_startup_program, in_static_mode, register_op,
)

__all__ = [
    "Optimizer", "SGD", "SGDOptimizer", "Momentum", "MomentumOptimizer",
    "LarsMomentum", "LarsMomentumOptimizer", "Adagrad", "AdagradOptimizer",
    "Adam", "AdamOptimizer", "Adamax", "AdamaxOptimizer", "DecayedAdagrad",
    "DecayedAdagradOptimizer", "Adadelta", "AdadeltaOptimizer", "RMSProp",
    "RMSPropOptimizer", "Ftrl", "FtrlOptimizer", "Lamb", "LambOptimizer",
    "ProximalGD", "ProximalGDOptimizer", "ProximalAdagrad",
    "ProximalAdagradOptimizer", "ModelAverage", "ExponentialMovingAverage",
]


class Optimizer:
    """Base of the update rules: the functional path of
    ``paddle_tpu.optimizer.Optimizer`` (init / apply_gradients / step).
    A subclass names its slots in ``_slot_defaults`` and updates the flat
    lists in ``_apply``."""

    _slot_defaults = {}       # slot name -> initial value

    def __init__(self, learning_rate=0.001, regularization=None,
                 grad_clip=None, name=None):
        if regularization is not None and not callable(regularization):
            raise EnforceNotMet(
                "regularization must be a (param, grad) -> grad callable "
                "such as regularizer.L2Decay(1e-4), got "
                f"{type(regularization).__name__}")
        if grad_clip is not None and not hasattr(grad_clip, "clip_tree"):
            raise EnforceNotMet(
                "grad_clip must have clip_tree(grads), as the clip module's "
                f"classes do, got {type(grad_clip).__name__}")
        self.learning_rate = (learning_rate if callable(learning_rate)
                              else float(learning_rate))
        self.regularization = regularization
        self.grad_clip = grad_clip
        self.name = name

    def _lr_value(self, step):
        """The rate of the update whose (incremented) counter is ``step``:
        a schedule's 0-d fp32 tensor on the counter's device, or the
        float."""
        if callable(self.learning_rate):
            return self.learning_rate(step.to(torch.float32))
        return self.learning_rate

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

    def apply_gradients(self, params, grads, state, param_meta=None):
        """One update, **in place**: params, the slots of ``state`` and its
        step counter are overwritten, and ``(params, state)`` (the same
        objects) are returned. ``grads`` is a tree like params; the trees
        are matched by key, not by order. The step counter is incremented,
        the rate taken at it, then the regularizer and the clip applied to
        the grads (out of place), then the rule's one launch. ``param_meta``
        is accepted and ignored, as in the JAX package (its
        decoupled-weight-decay extension passes it)."""
        rows = leaves(map_tree(
            lambda path, p, g, s: (p, _grad(path, p, g), s),
            params, grads, state["slots"]))
        ps, gs = [p for p, _, _ in rows], [g for _, g, _ in rows]
        state["step"].add_(1)
        with torch.no_grad():
            lr = self._lr_value(state["step"])
            if self.regularization is not None:
                gs = [self.regularization(p, g) for p, g in zip(ps, gs)]
            if self.grad_clip is not None:
                gs = self.grad_clip.clip_tree(gs)
            self._apply(ps, gs, [[s[k] for _, _, s in rows]
                                 for k in self._slot_defaults],
                        state["step"], lr)
        return params, state

    def step(self, params, grads, state=None):
        """One-call functional step: ``init`` first when ``state`` is None."""
        if state is None:
            state = self.init(params)
        return self.apply_gradients(params, grads, state)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        """Append the backward, the step counter's increment, the clip (the
        optimizer's ``grad_clip`` or the Program's, as one ``clip_grads``
        op over every grad) and one ``apply_optimizer`` op per parameter
        (with its ``ParamAttr`` regularizer and learning rate) to
        ``loss``'s program, and the slots' and step counter's initializers
        to the startup program (optimizer.py:127-221). Returns ``(update
        ops, [(param, grad)])``."""
        from paddle_tpu_torch.static.backward import append_backward
        if not in_static_mode():
            raise EnforceNotMet(
                "minimize() is the static-graph API; in eager mode use "
                "apply_gradients(params, grads, state)")
        program = loss.block.program
        blk = program.global_block()
        p_g = append_backward(loss, parameter_list, no_grad_set)
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

        clip = self.grad_clip or clip_mod.get_gradient_clip(program)
        if clip is not None:
            gnames = [g.name for _, g in p_g]
            blk.append_op(type="clip_grads", inputs={"X": gnames},
                          outputs={"Out": gnames}, attrs={"clip": clip})

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
                       "regularizer": p.regularizer,
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

    def _apply(self, params, grads, slots, step, lr):
        """The rule over the flat lists (``slots``: one list per slot name,
        in ``_slot_defaults`` order): the kernel rules launch once; the
        others run ``_update`` per parameter and write back in place."""
        names = list(self._slot_defaults)
        lr = _lr_tensor(lr, params[0].device)
        for i, (p, g) in enumerate(zip(params, grads)):
            self._update_in_place(p, g, {k: slots[j][i]
                                         for j, k in enumerate(names)},
                                  lr, step)

    def _update_in_place(self, p, g, slots, lr, step):
        new_p, new_slots = self._update(p, g, slots,
                                        _lr_tensor(lr, p.device), step)
        for k, v in new_slots.items():
            if v is not slots[k]:
                slots[k].copy_(v)
        p.copy_(new_p)

    def _update(self, p, g, slots, lr, t):
        """One parameter's rule, out of place: ``(new p, {slot: new
        value})``. ``lr`` is a 0-d fp32 tensor, ``t`` the int32 step
        counter after its increment."""
        raise NotImplementedError


def _lr_tensor(lr, device):
    """The rate as the JAX package holds it: a 0-d fp32 tensor (a fill on
    the device, no host copy)."""
    if isinstance(lr, torch.Tensor):
        return lr
    return torch.full((), lr, dtype=torch.float32, device=device)


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

    def _apply(self, params, grads, slots, step, lr):
        m1s, m2s = slots
        fused_adam(params, grads, m1s, m2s, lr, step,
                   beta1=self.beta1, beta2=self.beta2, epsilon=self.epsilon)


class SGDOptimizer(Optimizer):
    """sgd_op.cc: p -= lr * g. fp32 params."""

    def _apply(self, params, grads, slots, step, lr):
        fused_sgd(params, grads, lr)


class MomentumOptimizer(Optimizer):
    """momentum_op.cc: v = momentum * v + g, then p -= lr * v, or
    p -= lr * (g + momentum * v) with ``use_nesterov``. fp32 params."""

    _slot_defaults = {"velocity": 0.0}

    def __init__(self, learning_rate, momentum=0.9, use_nesterov=False,
                 **kw):
        super().__init__(learning_rate, **kw)
        self.momentum = momentum
        self.use_nesterov = use_nesterov

    def _apply(self, params, grads, slots, step, lr):
        (velocities,) = slots
        fused_momentum(params, grads, velocities, lr,
                       momentum=self.momentum,
                       use_nesterov=self.use_nesterov)


def _fused_update(opt, p, g, slots, lr, step):
    """One launch of the rule's kernel over the one parameter ``p``, in
    place (the counterpart of ``_pallas_fused_update``,
    optimizer.py:224-261), for SGD, Momentum and Adam; the other rules run
    their own update, as the JAX op does when ``_pallas_fused_update``
    returns None (optimizer.py:264-277). The stock rule's output dtype,
    which the JAX package pins by ``eval_shape``, is fp32 for fp32 inputs;
    the kernels take nothing else."""
    if type(opt) not in (AdamOptimizer, MomentumOptimizer, SGDOptimizer):
        opt._update_in_place(p, g, slots, lr, step)
        return
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


def kernel_library(opt):
    """The kernel library (``ops/kernels/_build.py``'s name) the static
    update of ``opt`` launches, or None for a rule without a kernel."""
    if type(opt) is AdamOptimizer:
        return "fused_adam"
    if type(opt) in (MomentumOptimizer, SGDOptimizer):
        return "fused_sgd"
    return None


def _apply_optimizer_compute(ins, attrs):
    """The static ``apply_optimizer`` op (optimizer.py:264-277): updates
    Param and Slots in place and returns them as ParamOut and SlotOuts. The
    grad takes the parameter's regularizer, else the optimizer's; the
    learning rate is the fp32 product of the optimizer's (a schedule's at
    the step, on the device) and the parameter's, as the JAX op computes
    it."""
    opt = attrs["opt"]
    p, g, step = ins["Param"][0], ins["Grad"][0], ins["Step"][0]
    slots = dict(zip(attrs["slot_names"], ins.get("Slots", [])))
    param_lr = attrs.get("param_lr", 1.0)
    with torch.no_grad():
        reg = attrs.get("regularizer") or opt.regularization
        if reg is not None:
            g = reg(p, g)
        if callable(opt.learning_rate):
            lr = opt._lr_value(step) * param_lr
        else:
            lr = float(np.float32(opt.learning_rate) * np.float32(param_lr))
        _fused_update(opt, p, g, slots, lr, step)
    return {"ParamOut": [p],
            "SlotOuts": [slots[k] for k in attrs["slot_names"]]}


register_op("apply_optimizer", _apply_optimizer_compute)
register_op("increment_step", lambda ins, attrs: {"Out": [ins["X"][0] + 1]})
register_op("clip_grads", lambda ins, attrs: {
    "Out": attrs["clip"].clip_tree(list(ins["X"]))})


# ---------------------------------------------------------------------------
# the rules without a kernel (operators/optimizers/*.cc; optimizer.py:326-552)
# ---------------------------------------------------------------------------
def _norm(x):
    return torch.sqrt(torch.sum(torch.square(x)))


class LarsMomentumOptimizer(Optimizer):
    """lars_momentum_op.cc: layer-wise adaptive rate scaling, the trust
    ratio from whole-tensor norms (1 where either norm is 0)."""

    _slot_defaults = {"velocity": 0.0}

    def __init__(self, learning_rate, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, **kw):
        super().__init__(learning_rate, **kw)
        self.momentum = momentum
        self.lars_coeff = lars_coeff
        self.lars_weight_decay = lars_weight_decay

    def _update(self, p, g, slots, lr, t):
        p_norm, g_norm = _norm(p), _norm(g)
        local_lr = torch.where(
            (p_norm > 0) & (g_norm > 0),
            self.lars_coeff * p_norm
            / (g_norm + self.lars_weight_decay * p_norm + 1e-12), 1.0)
        v = self.momentum * slots["velocity"] + lr * local_lr * (
            g + self.lars_weight_decay * p)
        return p - v, {"velocity": v}


class AdagradOptimizer(Optimizer):
    """adagrad_op.cc. ``initial_accumulator_value`` sets the slot's start
    on the instance, which ``init`` and ``minimize`` read."""

    _slot_defaults = {"moment": 0.0}

    def __init__(self, learning_rate, epsilon=1e-6,
                 initial_accumulator_value=0.0, **kw):
        super().__init__(learning_rate, **kw)
        self.epsilon = epsilon
        self._slot_defaults = {"moment": initial_accumulator_value}

    def _update(self, p, g, slots, lr, t):
        m = slots["moment"] + torch.square(g)
        return p - lr * g / (torch.sqrt(m) + self.epsilon), {"moment": m}


class AdamaxOptimizer(Optimizer):
    """adamax_op.cc"""

    _slot_defaults = {"moment": 0.0, "inf_norm": 0.0}

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _update(self, p, g, slots, lr, t):
        t = t.to(torch.float32)
        m = self.beta1 * slots["moment"] + (1 - self.beta1) * g
        u = torch.maximum(self.beta2 * slots["inf_norm"], torch.abs(g))
        new_p = p - lr / (1 - self.beta1 ** t) * m / (u + self.epsilon)
        return new_p, {"moment": m, "inf_norm": u}


class DecayedAdagradOptimizer(Optimizer):
    """decayed_adagrad_op.cc"""

    _slot_defaults = {"moment": 0.0}

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self.decay, self.epsilon = decay, epsilon

    def _update(self, p, g, slots, lr, t):
        m = self.decay * slots["moment"] + (1 - self.decay) * torch.square(g)
        return p - lr * g / (torch.sqrt(m) + self.epsilon), {"moment": m}


class AdadeltaOptimizer(Optimizer):
    """adadelta_op.cc"""

    _slot_defaults = {"avg_squared_grad": 0.0, "avg_squared_update": 0.0}

    def __init__(self, learning_rate=1.0, epsilon=1e-6, rho=0.95, **kw):
        super().__init__(learning_rate, **kw)
        self.epsilon, self.rho = epsilon, rho

    def _update(self, p, g, slots, lr, t):
        g2 = (self.rho * slots["avg_squared_grad"]
              + (1 - self.rho) * torch.square(g))
        upd = g * torch.sqrt(slots["avg_squared_update"] + self.epsilon) \
            / torch.sqrt(g2 + self.epsilon)
        u2 = (self.rho * slots["avg_squared_update"]
              + (1 - self.rho) * torch.square(upd))
        return p - lr * upd, {"avg_squared_grad": g2,
                              "avg_squared_update": u2}


class RMSPropOptimizer(Optimizer):
    """rmsprop_op.cc. Not centered, ``mean_grad`` is carried unchanged;
    ``momentum`` scales the previous step's move."""

    _slot_defaults = {"mean_square": 0.0, "mean_grad": 0.0, "momentum": 0.0}

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, **kw):
        super().__init__(learning_rate, **kw)
        self.rho, self.epsilon = rho, epsilon
        self.momentum_coef = momentum
        self.centered = centered

    def _update(self, p, g, slots, lr, t):
        ms = self.rho * slots["mean_square"] + (1 - self.rho) * torch.square(g)
        mg = (self.rho * slots["mean_grad"] + (1 - self.rho) * g
              if self.centered else slots["mean_grad"])
        denom = ms - torch.square(mg) if self.centered else ms
        mom = self.momentum_coef * slots["momentum"] \
            + lr * g / torch.sqrt(denom + self.epsilon)
        return p - mom, {"mean_square": ms, "mean_grad": mg,
                         "momentum": mom}


class FtrlOptimizer(Optimizer):
    """ftrl_op.cc: sqrt at ``lr_power`` -0.5, pow otherwise; divides by
    the rate."""

    _slot_defaults = {"squared": 0.0, "linear": 0.0}

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kw):
        super().__init__(learning_rate, **kw)
        self.l1, self.l2, self.lr_power = l1, l2, lr_power

    def _update(self, p, g, slots, lr, t):
        sq, lin = slots["squared"], slots["linear"]
        new_sq = sq + torch.square(g)
        if self.lr_power == -0.5:
            sigma = (torch.sqrt(new_sq) - torch.sqrt(sq)) / lr
            denom = torch.sqrt(new_sq) / lr + 2 * self.l2
        else:
            sigma = (new_sq ** -self.lr_power - sq ** -self.lr_power) / lr
            denom = new_sq ** -self.lr_power / lr + 2 * self.l2
        new_lin = lin + g - sigma * p
        pre = torch.clamp(new_lin, -self.l1, self.l1) - new_lin
        return pre / denom, {"squared": new_sq, "linear": new_lin}


class ProximalGDOptimizer(Optimizer):
    """proximal_gd_op.cc: prox = p - lr*g; p = sign(prox) * max(|prox| -
    lr*l1, 0) / (1 + lr*l2)."""

    def __init__(self, learning_rate, l1=0.0, l2=0.0, **kw):
        super().__init__(learning_rate, **kw)
        self.l1, self.l2 = l1, l2

    def _prox(self, prox, lr):
        return (torch.sign(prox)
                * torch.clamp(torch.abs(prox) - lr * self.l1, min=0.0)
                / (1.0 + lr * self.l2))

    def _update(self, p, g, slots, lr, t):
        return self._prox(p - lr * g, lr), slots


class ProximalAdagradOptimizer(ProximalGDOptimizer):
    """proximal_adagrad_op.cc: m += g^2; prox = p - lr*g/sqrt(max(m,
    1e-12)); then ProximalGD's shrink."""

    _slot_defaults = {"moment": 0.0}

    def _update(self, p, g, slots, lr, t):
        m = slots["moment"] + torch.square(g)
        prox = p - lr * g / torch.sqrt(torch.clamp(m, min=1e-12))
        return self._prox(prox, lr), {"moment": m}


class LambOptimizer(Optimizer):
    """lamb_op.cc: layer-adaptive Adam with weight decay, the trust ratio
    from whole-tensor norms. ``exclude_from_weight_decay_fn`` is kept and
    applies nowhere, as in the JAX package."""

    _slot_defaults = {"moment1": 0.0, "moment2": 0.0}

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6,
                 exclude_from_weight_decay_fn=None, **kw):
        super().__init__(learning_rate, **kw)
        self.wd = lamb_weight_decay
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.exclude_fn = exclude_from_weight_decay_fn

    def _update(self, p, g, slots, lr, t):
        t = t.to(torch.float32)
        m1 = self.beta1 * slots["moment1"] + (1 - self.beta1) * g
        m2 = self.beta2 * slots["moment2"] + (1 - self.beta2) * torch.square(g)
        m1h = m1 / (1 - self.beta1 ** t)
        m2h = m2 / (1 - self.beta2 ** t)
        r = m1h / (torch.sqrt(m2h) + self.epsilon) + self.wd * p
        p_norm, r_norm = _norm(p), _norm(r)
        trust = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm, 1.0)
        return p - lr * trust * r, {"moment1": m1, "moment2": m2}


class ModelAverage(Optimizer):
    """optimizer.py:2244 parity, functional: ``state = ma.init(params)``,
    ``ma.accumulate(params, state)`` (in place; returns ``state``), then
    ``ma.average(state)``, the parameters to evaluate with. Only
    ``max_average_window`` is kept, as in the JAX package, and it bounds
    nothing there either. There is no update rule: ``apply_gradients``
    raises."""

    def __init__(self, average_window_rate=0.15, min_average_window=10000,
                 max_average_window=10000, **kw):
        super().__init__(0.0, **kw)
        self.max_window = max_average_window

    def init(self, params):
        flat = leaves(params)
        if not flat:
            raise EnforceNotMet("init: params has no tensors")
        return {"sum": map_tree(lambda _, p: torch.zeros_like(p), params),
                "count": torch.zeros((), dtype=torch.int32,
                                     device=flat[0].device)}

    def accumulate(self, params, state):
        with torch.no_grad():
            map_tree(lambda _, s, p: s.add_(p), state["sum"], params)
            state["count"].add_(1)
        return state

    def average(self, state):
        c = torch.clamp(state["count"], min=1).to(torch.float32)
        return map_tree(lambda _, s: s / c, state["sum"])

    def apply_gradients(self, params, grads, state, param_meta=None):
        raise NotImplementedError(
            "ModelAverage keeps a running sum of the parameters "
            "(accumulate / average); it has no update rule")


class ExponentialMovingAverage:
    """optimizer.py:2434 parity, functional: ``state = ema.init(params)``,
    ``ema.update(params, state)`` (in place; returns ``state``), then
    ``ema.apply(state)``. The decay of update t is ``min(decay, (1 + t) /
    (10 + t))`` in fp32 on the counter's device; ``thres_steps`` is kept
    and applies nowhere, as in the JAX package."""

    def __init__(self, decay=0.999, thres_steps=None):
        self.decay = decay

    def init(self, params):
        flat = leaves(params)
        if not flat:
            raise EnforceNotMet("init: params has no tensors")
        return {"ema": map_tree(lambda _, p: p.detach().clone(), params),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=flat[0].device)}

    def update(self, params, state):
        state["step"].add_(1)
        s = state["step"].to(torch.float32)
        d = torch.clamp((1.0 + s) / (10.0 + s), max=self.decay)
        with torch.no_grad():
            map_tree(lambda _, e, p: e.copy_(d * e + (1 - d) * p),
                     state["ema"], params)
        return state

    def apply(self, state):
        return state["ema"]


# fluid-style short aliases
SGD = SGDOptimizer
Momentum = MomentumOptimizer
LarsMomentum = LarsMomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
Lamb = LambOptimizer
ProximalGD = ProximalGDOptimizer
ProximalAdagrad = ProximalAdagradOptimizer
