"""Static autodiff: the port of ``paddle_tpu/static/backward.py``.

``append_backward`` appends one ``autodiff`` op marking "differentiate the
block prefix with respect to the trainable parameters", with ``<param>@GRAD``
output vars. The Executor runs it as ``torch.autograd.grad`` of the summed
loss over the interpreted prefix.
"""

from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.static.program import Parameter

__all__ = ["GRAD_SUFFIX", "append_backward"]

GRAD_SUFFIX = "@GRAD"


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None, checkpoints=None):
    """Append the autodiff marker and the grad vars; returns
    ``[(param, grad_var)]``. ``callbacks`` is ignored, as in the JAX
    package; recompute ``checkpoints`` are not ported yet."""
    if checkpoints:
        raise EnforceNotMet(
            "append_backward(checkpoints=...): recompute segments in the "
            "static executor are not ported yet (ROADMAP queue 1 item 5)")
    blk = loss.block.program.global_block()
    params = [p for p in blk.all_parameters()
              if isinstance(p, Parameter) and p.trainable]
    if parameter_list:
        wanted = {p if isinstance(p, str) else p.name
                  for p in parameter_list}
        params = [p for p in params if p.name in wanted]
    if no_grad_set:
        banned = {p if isinstance(p, str) else p.name for p in no_grad_set}
        params = [p for p in params if p.name not in banned]
    grad_vars = [blk.create_var(name=p.name + GRAD_SUFFIX, shape=p.shape,
                                dtype=p.dtype) for p in params]
    blk.append_op(
        type="autodiff",
        inputs={"Loss": [loss.name]},
        outputs={"Grads": [g.name for g in grad_vars]},
        attrs={"loss": loss.name, "params": [p.name for p in params],
               "checkpoint": False})
    return list(zip(params, grad_vars))
