"""Optimizers: the port of ``paddle_tpu/optimizer.py``'s functional path.

``state = opt.init(params)`` then ``opt.apply_gradients(params, grads,
state)``, with params, grads and slots as nested dicts and lists of
tensors. Where the JAX package returns new arrays (and donates the old
ones), the port updates params, slots and the step counter **in place** and
returns the same trees: one launch of the ``fused_adam`` kernel over the
whole parameter list per step on the card, its plain PyTorch version on the
CPU.

This slice ports Adam only. A callable learning rate (a schedule),
``regularization``, ``grad_clip``, the other update rules and the static
path (``minimize``) raise :class:`EnforceNotMet` naming the ROADMAP item
that ports them.
"""

import numpy as np
import torch

from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.core.tree import leaves, map_tree
from paddle_tpu_torch.ops.kernels import fused_adam

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

    def minimize(self, *args, **kwargs):
        raise EnforceNotMet(
            "minimize() is the static-graph API, not ported yet (ROADMAP "
            "queue 1 item 5); use apply_gradients(params, grads, state)")

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


class _NotPorted(Optimizer):
    def __init__(self, *args, **kwargs):
        raise EnforceNotMet(
            f"{type(self).__name__} is not ported yet: its fused kernel "
            "(pallas/optimizer.py _sgd_kernel / _momentum_kernel) is ROADMAP "
            "queue 2 row 10; BERT trains with Adam")


class SGDOptimizer(_NotPorted):
    """Not ported yet (raises)."""


class MomentumOptimizer(_NotPorted):
    """Not ported yet (raises)."""


Adam = AdamOptimizer
SGD = SGDOptimizer
Momentum = MomentumOptimizer
