"""Static autodiff: the port of ``paddle_tpu/static/backward.py``.

``append_backward`` appends one ``autodiff`` op marking "differentiate the
block prefix with respect to the trainable parameters", with ``<param>@GRAD``
output vars. The Executor runs it as ``torch.autograd.grad`` of the summed
loss over the interpreted prefix.
"""

from paddle_tpu_torch.static.program import Parameter

__all__ = ["GRAD_SUFFIX", "append_backward", "gradients", "calc_gradient"]

GRAD_SUFFIX = "@GRAD"


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None, checkpoints=None):
    """Append the autodiff marker and the grad vars; returns
    ``[(param, grad_var)]``. ``callbacks`` is ignored, as in the JAX
    package; ``checkpoints`` only records ``"checkpoint": bool(checkpoints)``
    in the op's attrs, as the JAX function does (nothing there reads it:
    no recompute happens, and the gradients are the same)."""
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
               "checkpoint": bool(checkpoints)})
    return list(zip(params, grad_vars))


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """fluid.gradients parity (calc_gradient, backward.py:695), in the JAX
    package's restricted form: ``targets`` is one loss var, ``inputs``
    parameters; returns their grad vars."""
    t = targets[0] if isinstance(targets, (list, tuple)) else targets
    pg = append_backward(t, parameter_list=[
        i if isinstance(i, str) else i.name
        for i in (inputs if isinstance(inputs, (list, tuple)) else [inputs])])
    return [g for _, g in pg]


#: fluid's name for the same entry point (backward.py:695)
calc_gradient = gradients
