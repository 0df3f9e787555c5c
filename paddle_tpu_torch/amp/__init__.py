"""Automatic mixed precision: the port of ``paddle_tpu/amp/__init__.py``
(the reference's contrib/mixed_precision: decorator.py:27
OptimizerWithMixedPrecision, fp16_lists.py's lists, dynamic loss scaling).

The policy casts at the function boundary: parameters stay fp32 (the
master weights), the model computes in the policy's half dtype
(``cast_params``), and under fp16 a :class:`LossScaler` scales the loss
and unscales the grads. bfloat16 needs no scaling.

A non-finite fp16 step is skipped as the JAX package skips it
(``jnp.where(finite, new, old)``): params, optimizer slots and the step
counter keep their values, bit for bit. The port's optimizer updates in
place, so :meth:`OptimizerWithMixedPrecision.apply_gradients` keeps a
snapshot of params, slots and step counter (one copy of each: for Adam
three times the fp32 parameter bytes, plus 4 bytes), runs the update, then
selects each tensor against its snapshot on the device with the 0-d
``finite`` flag. Nothing is read on the host.
"""

import torch

from paddle_tpu_torch.core.tree import map_tensors, tensors

__all__ = [
    "Policy", "bfloat16_policy", "float16_policy", "cast_tree",
    "LossScaler", "decorate", "black_list", "white_list",
    "AutoMixedPrecisionLists",
]

# fp16_lists.py parity: ops that must stay fp32 under half policies
black_list = {"softmax_with_cross_entropy", "cross_entropy", "mean",
              "layer_norm", "batch_norm", "reduce_sum", "exp", "log"}
white_list = {"matmul", "mul", "conv2d", "fc"}


class Policy:
    def __init__(self, compute_dtype, param_dtype=torch.float32,
                 output_dtype=torch.float32):
        self.compute_dtype = compute_dtype
        self.param_dtype = param_dtype
        self.output_dtype = output_dtype


def bfloat16_policy():
    return Policy(torch.bfloat16)


def float16_policy():
    return Policy(torch.float16)


def cast_tree(tree, dtype):
    """The floating tensors of ``tree`` cast to ``dtype``; others kept."""
    return map_tensors(lambda x: x.to(dtype) if x.is_floating_point()
                       else x, tree)


class LossScaler:
    """Dynamic loss scaling (decorator.py's incr/decr_every_n rule). The
    state is three 0-d tensors on the device, updated with ``torch.where``,
    so a step reads nothing on the host."""

    def __init__(self, init_loss_scaling=2.0 ** 15, incr_ratio=2.0,
                 decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self.incr_ratio = incr_ratio
        self.decr_ratio = decr_ratio
        self.incr_every_n = incr_every_n_steps
        self.decr_every_n = decr_every_n_nan_or_inf
        self.dynamic = use_dynamic_loss_scaling
        self.init_scale = init_loss_scaling

    def init(self, device=None):
        """{"scale": fp32, "good": int32, "bad": int32}, 0-d, on
        ``device`` (the card when None)."""
        from paddle_tpu_torch import resolve_device
        dev = resolve_device(device)
        return {"scale": torch.tensor(self.init_scale, dtype=torch.float32,
                                      device=dev),
                "good": torch.zeros((), dtype=torch.int32, device=dev),
                "bad": torch.zeros((), dtype=torch.int32, device=dev)}

    def scale_loss(self, loss, state):
        return loss * state["scale"]

    def unscale_and_update(self, grads, state):
        """Returns (unscaled grads, 0-d bool ``finite``, new state)."""
        inv = 1.0 / state["scale"]
        grads = map_tensors(lambda g: g * inv, grads)
        finite = torch.stack([torch.isfinite(g).all()
                              for g in tensors(grads)]).all()
        if not self.dynamic:
            return grads, finite, state
        zero = torch.zeros_like(state["good"])
        good = torch.where(finite, state["good"] + 1, zero)
        bad = torch.where(finite, zero, state["bad"] + 1)
        scale = state["scale"]
        scale = torch.where(good >= self.incr_every_n,
                            scale * self.incr_ratio, scale)
        good = torch.where(good >= self.incr_every_n, zero, good)
        scale = torch.where(bad >= self.decr_every_n,
                            torch.clamp(scale * self.decr_ratio, min=1.0),
                            scale)
        bad = torch.where(bad >= self.decr_every_n, zero, bad)
        return grads, finite, {"scale": scale, "good": good, "bad": bad}


class OptimizerWithMixedPrecision:
    """The product of :func:`decorate`: an Optimizer for half-precision
    training, with its functional protocol (``init(params)``,
    ``apply_gradients(params, grads, state)``, in place). Grads come from
    a loss scaled by ``scale_loss``; a non-finite step leaves params,
    slots and the step counter unchanged (decorator.py's update halting)."""

    def __init__(self, optimizer, policy=None, scaler=None):
        self.opt = optimizer
        self.policy = policy or bfloat16_policy()
        needs_scaler = self.policy.compute_dtype == torch.float16
        self.scaler = scaler or (LossScaler() if needs_scaler else None)

    def init(self, params):
        st = {"opt": self.opt.init(params)}
        if self.scaler:
            st["loss_scale"] = self.scaler.init(
                device=tensors(params)[0].device)
        return st

    def cast_params(self, params):
        return cast_tree(params, self.policy.compute_dtype)

    def scale_loss(self, loss, state):
        if self.scaler:
            return self.scaler.scale_loss(loss, state["loss_scale"])
        return loss

    def apply_gradients(self, params, grads, state):
        """One update in place; returns ``(params, state)``. Under a
        scaler the grads are unscaled, the scale state moves on, and where
        a grad is not finite every tensor the update wrote is put back
        from its snapshot (a device select, no host read)."""
        grads = cast_tree(grads, torch.float32)
        if not self.scaler:
            self.opt.apply_gradients(params, grads, state["opt"])
            return params, state
        grads, finite, ls = self.scaler.unscale_and_update(
            grads, state["loss_scale"])
        written = tensors(params) + tensors(state["opt"])
        with torch.no_grad():
            snapshot = [t.clone() for t in written]
            self.opt.apply_gradients(params, grads, state["opt"])
            for t, old in zip(written, snapshot):
                t.copy_(torch.where(finite, t, old))
        state["loss_scale"] = ls
        return params, state

    def monitor_state(self, state, step=None):
        """Publish the loss-scale state to ``monitor.tensorwatch``: the
        ``loss_scale`` gauge and a ``loss_scale_decrements_total`` count for
        each observed decrement (a non-finite fp16 gradient the scaler
        absorbed). Call between steps: it reads the 0-d scale once. Returns
        the float scale (None without a scaler: bf16 needs no scaling, so
        there is nothing to watch)."""
        if not self.scaler or "loss_scale" not in state:
            return None
        from paddle_tpu_torch.monitor import tensorwatch
        return tensorwatch.record_loss_scale(
            state["loss_scale"]["scale"], step=step)


def decorate(optimizer, amp_lists=None, init_loss_scaling=2.0 ** 15,
             use_dynamic_loss_scaling=True, use_bf16=True):
    """contrib.mixed_precision.decorate parity: the bf16 policy, or fp16
    with a :class:`LossScaler`."""
    policy = bfloat16_policy() if use_bf16 else float16_policy()
    scaler = None
    if not use_bf16:
        scaler = LossScaler(init_loss_scaling,
                            use_dynamic_loss_scaling=use_dynamic_loss_scaling)
    return OptimizerWithMixedPrecision(optimizer, policy, scaler)


class AutoMixedPrecisionLists:
    """contrib.mixed_precision.fp16_lists.AutoMixedPrecisionLists parity:
    the user's white and black lists merged into the defaults (an op
    custom-listed white leaves black, and the other way round)."""

    def __init__(self, custom_white_list=None, custom_black_list=None):
        self.white_list = set(white_list)
        self.black_list = set(black_list)
        self.gray_list = set()
        if custom_white_list:
            for op in custom_white_list:
                self.black_list.discard(op)
                self.white_list.add(op)
        if custom_black_list:
            for op in custom_black_list:
                if op in (custom_white_list or ()):
                    raise ValueError(
                        f"op {op} in both custom white and black lists")
                self.white_list.discard(op)
                self.black_list.add(op)
