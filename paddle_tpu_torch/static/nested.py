"""Nested sub-program control flow for static Programs: the port of
``paddle_tpu/static/nested.py``.

Parity: the reference stores control-flow bodies as sub-BlockDescs
referenced from OpDesc BLOCK attrs (framework.proto:43 attr type BLOCK;
operators/controlflow/while_op.cc, recurrent_op.cc). A body callable is
traced once into a sub-Program (symbolic Variables through the same
``layers`` ops as the parent), the op carries the sub-Program in its attrs
(so the program serializes, ``static/serialize.py``), and the op's compute
interprets the sub-Program through ``exec_op``:

- ``while_block`` is a Python loop that reads its 0-d predicate on the host
  once per iteration (``ops.control_flow.host_reads`` counts the reads);
  the Executor refuses to differentiate through one, as ``lax.while_loop``
  refuses reverse-mode differentiation in the JAX package;
- ``scan_block`` steps over the time axis and reads nothing on the host.
  Its ops run inside the Executor's autograd region, so the gradients of
  the parameters the body captures flow through the loop, as through
  ``lax.scan``.

Variables a body closes over (parent parameters) are captures and ride the
op's input list (while_op.cc's kX inputs). A body may hold no op that draws
(``_needs_rng``) and no host op, with the JAX package's messages.
"""

import torch

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.ops import control_flow as _cf
from paddle_tpu_torch.static.program import (
    OP_REGISTRY, Program, default_main_program, in_static_mode,
    program_guard,
)

__all__ = ["static_while_loop", "static_rnn_block", "trace_subprogram"]


def _static_shape(shape, name):
    enforce(shape is not None,
            f"control-flow var {name!r} has unknown shape")
    return tuple(2 if (s is None or s == -1) else int(s) for s in shape)


def _as_program_var(v, tag):
    """A loop or capture value may be a concrete tensor (a static-mode
    ``fill_constant`` with no tensor inputs evaluates at once): it becomes
    a named constant of the parent program so the block op can reference
    it by name."""
    from paddle_tpu_torch.framework import unique_name
    if hasattr(v, "name") and hasattr(v, "block"):
        return v
    arr = torch.as_tensor(v)
    program = default_main_program()
    name = unique_name.generate(f"const_{tag}")
    nv = program.global_block().create_var(name=name, shape=arr.shape,
                                           dtype=arr.dtype)
    program._constants[name] = arr
    return nv


def trace_subprogram(fn, input_vars, input_shapes=None):
    """Trace ``fn`` (taking len(input_vars) symbolic Variables) into a
    fresh sub-Program. Returns (sub_program, in_names, out_names,
    captured_names). ``input_shapes`` overrides the inputs' shapes (a scan
    body sees one time slice of its sequence)."""
    from paddle_tpu_torch.framework import unique_name

    sub = Program()
    startup = Program()   # throwaway; body fns must not create params
    in_names, sym = [], []
    with program_guard(sub, startup), unique_name.guard():
        blk = sub.global_block()
        for i, v in enumerate(input_vars):
            shape = (input_shapes[i] if input_shapes is not None
                     else v.shape)
            nv = blk.create_var(name=f"@in@{i}@{v.name}", shape=shape,
                                dtype=v.dtype, is_data=True)
            in_names.append(nv.name)
            sym.append(nv)
        outs = fn(*sym)
    if not isinstance(outs, (list, tuple)):
        outs = [outs]
    out_names = []
    for o in outs:
        enforce(hasattr(o, "name"),
                "control-flow body must return program Variables "
                "(build outputs with layers ops)")
        out_names.append(o.name)
    enforce(not startup.global_block().ops,
            "control-flow bodies must not create parameters — close "
            "over parent parameters instead (they become captures)")
    defined = set(blk.vars) | set(sub._constants)
    captured = []
    for op in blk.ops:
        enforce(not op.attrs.get("_host"),
                f"host op {op.type!r} inside a control-flow body")
        enforce(not op.attrs.get("_needs_rng"),
                f"rng op {op.type!r} inside a control-flow body is not "
                f"supported yet (hoist randomness out of the loop)")
        for n in op.input_names():
            if n not in defined and n not in captured:
                captured.append(n)
    return sub, in_names, out_names, captured


def _run_subprogram(prog, in_names, in_vals, captured, cap_vals,
                    out_names):
    """Interpret a sub-Program: its inputs and captures in, its outputs
    out; its constants go to the device of its first input."""
    from paddle_tpu_torch.static.executor import exec_op
    dev = in_vals[0].device
    env = {n: c.to(dev) for n, c in prog._constants.items()}
    env.update(zip(in_names, in_vals))
    env.update(zip(captured, cap_vals))
    for op in prog.global_block().ops:
        env.update(exec_op(op, env))
    return [env[n] for n in out_names]


# ---------------------------------------------------------------------------
# while_block
# ---------------------------------------------------------------------------
def _while_block_compute(ins, attrs):
    n_loop = attrs["n_loop"]
    vals = list(ins["X"])
    loop_vals, cap_vals = vals[:n_loop], vals[n_loop:]
    captured = attrs["captured"]

    def cond(vs):
        return _run_subprogram(attrs["cond_program"], attrs["cond_in"], vs,
                               captured, cap_vals, attrs["cond_out"])[0]

    out = _cf.while_loop(
        lambda *vs: cond(list(vs)),
        lambda *vs: _run_subprogram(attrs["body_program"], attrs["body_in"],
                                    list(vs), captured, cap_vals,
                                    attrs["body_out"]),
        list(loop_vals))
    return {"Out": list(out)}


OP_REGISTRY["while_block"] = _while_block_compute


def static_while_loop(cond_fn, body_fn, loop_vars):
    """Static-mode layers.while_loop (ref layers/control_flow.py:630 While
    + while_op.cc): the bodies traced to sub-programs held in op attrs, so
    the program serializes."""
    enforce(in_static_mode(), "static_while_loop requires static mode")
    single = not isinstance(loop_vars, (tuple, list))
    lvars = [loop_vars] if single else list(loop_vars)
    lvars = [_as_program_var(v, "while_in") for v in lvars]

    cond_p, cond_in, cond_out, cap_c = trace_subprogram(cond_fn, lvars)
    enforce(len(cond_out) == 1, "while cond must return one boolean")
    body_p, body_in, body_out, cap_b = trace_subprogram(body_fn, lvars)
    enforce(len(body_out) == len(lvars),
            f"while body returned {len(body_out)} vars for "
            f"{len(lvars)} loop vars")
    captured = list(dict.fromkeys(cap_c + cap_b))

    blk = default_main_program().global_block()
    outs = [blk.create_var(shape=v.shape, dtype=v.dtype) for v in lvars]
    blk.append_op(
        type="while_block",
        inputs={"X": [v.name for v in lvars] + captured},
        outputs={"Out": [o.name for o in outs]},
        attrs={"n_loop": len(lvars), "captured": captured,
               "cond_program": cond_p, "cond_in": cond_in,
               "cond_out": cond_out, "body_program": body_p,
               "body_in": body_in, "body_out": body_out})
    return outs[0] if single else outs


# ---------------------------------------------------------------------------
# scan_block (StaticRNN)
# ---------------------------------------------------------------------------
def _scan(attrs, seq, mem, cap_vals):
    """The body over seq's time axis (dim 1): (final state, outputs
    [B, T, ...])."""
    outs = []
    for t in range(seq.shape[1]):
        mem, out_t = _run_subprogram(
            attrs["body_program"], attrs["body_in"], [mem, seq[:, t]],
            attrs["captured"], cap_vals, attrs["body_out"])
        outs.append(out_t)
    return mem, torch.stack(outs, dim=1)


def _scan_block_compute(ins, attrs):
    seq, mem, *cap_vals = ins["X"]
    final, outs = _scan(attrs, seq, mem, cap_vals)
    return {"Out": [final, outs]}


OP_REGISTRY["scan_block"] = _scan_block_compute


def static_rnn_block(step_fn, inputs, initial_state):
    """Static-mode StaticRNN (ref layers/control_flow.py:280 +
    recurrent_op.cc), the eager ``static_rnn``'s surface: ``inputs`` a
    [B, T, ...] Variable, ``initial_state`` a [B, ...] Variable and
    ``step_fn(state, x_t) -> (new_state, out_t)`` built from layers ops.
    Returns (final_state, outs [B, T, ...]) Variables. ``out_t``'s shape
    comes from running the body once on zeros on the CPU, under no_grad,
    with 2 for every unknown dim; a batch dim the body keeps is declared as
    the input declares it."""
    enforce(in_static_mode(), "static_rnn_block requires static mode")
    seq, mem = inputs, initial_state
    enforce(seq.shape is not None and len(seq.shape) >= 2,
            "sequence input must be [B, T, ...]")
    slice_shape = (seq.shape[0],) + tuple(seq.shape[2:])

    body_p, body_in, body_out, captured = trace_subprogram(
        lambda m, x_t: step_fn(m, x_t),
        [mem, seq], input_shapes=[mem.shape, slice_shape])
    enforce(len(body_out) == 2,
            "step_fn must return (new_state, out_t)")

    blk = default_main_program().global_block()
    T = seq.shape[1]

    def zeros(shape, dtype, name):
        return torch.zeros(_static_shape(shape, name), dtype=dtype)

    with torch.no_grad():
        st, out_t = _run_subprogram(
            body_p, body_in,
            [zeros(mem.shape, mem.dtype, "state"),
             zeros(slice_shape, seq.dtype, "x_t")],
            captured, [zeros(blk.var(n).shape, blk.var(n).dtype, n)
                       for n in captured], body_out)

    final = blk.create_var(shape=mem.shape, dtype=st.dtype)
    # a dynamic batch dim (-1/None) was probed with a placeholder (2):
    # declare the input's marker, not the probe's value, wherever the body
    # kept the batch extent
    batch = seq.shape[0]
    probed_batch = _static_shape(slice_shape, "x_t")[0]
    out_batch = batch if out_t.shape[0] == probed_batch else out_t.shape[0]
    out = blk.create_var(shape=(out_batch, T) + tuple(out_t.shape[1:]),
                         dtype=out_t.dtype)
    blk.append_op(
        type="scan_block",
        inputs={"X": [seq.name, mem.name] + captured},
        outputs={"Out": [final.name, out.name]},
        attrs={"captured": captured, "body_program": body_p,
               "body_in": body_in, "body_out": body_out})
    return final, out
