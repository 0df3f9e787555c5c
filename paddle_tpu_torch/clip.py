"""Gradient clipping: the port of ``paddle_tpu/clip.py``.

A clip object transforms a tree (nested dicts and lists) of grads:
``GradientClipByGlobalNorm`` over the whole tree, the others per tensor,
out of place. The class names are the JAX package's, so a program document
that holds one (the ``clip_grads`` op's ``clip``) loads in the port.
"""

import torch

from paddle_tpu_torch.core.tree import leaves, map_tree

__all__ = [
    "GradientClipByValue", "GradientClipByNorm", "GradientClipByGlobalNorm",
    "ErrorClipByValue", "set_gradient_clip", "global_norm",
]


def global_norm(tree):
    """sqrt(sum of squares) over every leaf of a tree, the per-leaf sums
    added in leaf order as the JAX package adds them."""
    flat = leaves(tree)
    if not flat:
        return torch.zeros(())
    return torch.sqrt(sum(torch.sum(torch.square(g)) for g in flat))


class GradientClipBase:
    def clip_tree(self, grads):
        """grads: a tree of tensors -> the same tree, clipped."""
        raise NotImplementedError


class GradientClipByValue(GradientClipBase):
    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def clip_tree(self, grads):
        return map_tree(lambda _, g: torch.clamp(g, self.min, self.max),
                        grads)


class GradientClipByNorm(GradientClipBase):
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def clip_tree(self, grads):
        def one(_, g):
            n = torch.sqrt(torch.sum(torch.square(g)))
            return g * (self.clip_norm / torch.clamp(n, min=self.clip_norm))
        return map_tree(one, grads)


class GradientClipByGlobalNorm(GradientClipBase):
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def clip_tree(self, grads):
        gn = global_norm(grads)
        scale = self.clip_norm / torch.clamp(gn, min=self.clip_norm)
        return map_tree(lambda _, g: g * scale, grads)


class ErrorClipByValue:
    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min


def set_gradient_clip(clip, param_list=None, program=None):
    """fluid.clip.set_gradient_clip: the default clip of ``minimize`` in
    static mode, stored on the Program itself (``default_main_program()``
    unless given)."""
    from paddle_tpu_torch.static.program import default_main_program
    program = program or default_main_program()
    program._grad_clip = clip


def get_gradient_clip(program):
    return getattr(program, "_grad_clip", None)
