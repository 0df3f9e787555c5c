"""Structured control flow: the port of ``paddle_tpu/ops/control_flow.py``.

Parity targets: operators/controlflow/ (while_op.cc,
conditional_block_op.cc), layers/control_flow.py (While:630, IfElse:1564,
Switch:1436, StaticRNN:280, DynamicRNN:1700).

The JAX package lowers these to ``lax.cond``/``switch``/``while_loop``/
``scan``, traced once. Eager Python control flow is the port's counterpart
(no ``torch.cond`` or ``torch.compile``), and what it reads on the host is
kept to the least the semantics need:

- ``cond``, ``case`` and ``switch_case`` run one branch, chosen by one host
  read (``case`` reads all its predicates at once), as ``lax.cond`` runs one
  branch;
- ``while_loop`` reads its 0-d predicate on the host once per iteration and
  nothing else (one read more than it has iterations);
- ``scan``, ``static_rnn`` and ``dynamic_rnn`` read nothing on the host:
  ``dynamic_rnn`` freezes a row past its length with ``torch.where``, as
  the JAX body does.

:func:`host_reads` counts the reads of the first two kinds since
:func:`reset_host_reads`.
"""

import threading

import torch

from paddle_tpu_torch.core.lod import RaggedBatch

__all__ = [
    "cond", "case", "switch_case", "while_loop", "scan", "static_rnn",
    "dynamic_rnn",
]

_reads = threading.local()


def host_reads():
    """The predicates and branch indices read on the host by this thread
    since :func:`reset_host_reads`."""
    return getattr(_reads, "n", 0)


def reset_host_reads():
    _reads.n = 0


def _read(x):
    """One host read of a predicate or an index (a 0-d or one-element
    tensor, or a Python value)."""
    _reads.n = host_reads() + 1
    if isinstance(x, torch.Tensor):
        return x.reshape(()).item()
    return x


def _tree_map(fn, *trees):
    """``fn`` over the leaves of tuples, lists and dicts of tensors."""
    t = trees[0]
    if isinstance(t, (tuple, list)):
        return type(t)(_tree_map(fn, *(r[i] for r in trees))
                       for i in range(len(t)))
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(r[k] for r in trees)) for k in t}
    return fn(*trees)


def _tree_leaves(t):
    if isinstance(t, (tuple, list)):
        return [x for v in t for x in _tree_leaves(v)]
    if isinstance(t, dict):
        return [x for v in t.values() for x in _tree_leaves(v)]
    return [t]


def cond(pred, true_fn, false_fn, operands=()):
    """conditional_block / layers.cond parity: one branch runs."""
    fn = true_fn if _read(pred) else false_fn
    return fn(*operands)


def case(pred_fn_pairs, default=None):
    """layers.case parity: the first true predicate's function runs; with
    no default the last pair's function is it, as in the JAX package."""
    preds = [p for p, _ in pred_fn_pairs]
    fns = [f for _, f in pred_fn_pairs]
    if default is None:
        default = fns[-1]
        preds, fns = preds[:-1], fns[:-1]
    if not preds:
        return default()
    hits = _read_all(preds)
    for hit, fn in zip(hits, fns):
        if hit:
            return fn()
    return default()


def _read_all(preds):
    """Every predicate in one host read."""
    _reads.n = host_reads() + 1
    if not any(isinstance(p, torch.Tensor) for p in preds):
        return [bool(p) for p in preds]
    dev = next(p.device for p in preds if isinstance(p, torch.Tensor))
    flags = torch.stack([torch.as_tensor(p, device=dev).reshape(())
                         .to(torch.bool) for p in preds])
    return flags.tolist()


def switch_case(branch_index, branch_fns, default=None):
    """layers.switch_case parity: a dict's keys are matched (no match takes
    the default, or the smallest key's function without one); a list's
    index is clipped to its range, the default appended last."""
    idx = int(_read(branch_index))
    if isinstance(branch_fns, dict):
        keys = sorted(branch_fns)
        if idx in branch_fns:
            return branch_fns[idx]()
        return default() if default is not None else branch_fns[keys[0]]()
    fns = list(branch_fns)
    if default is not None:
        fns.append(default)
    return fns[min(max(idx, 0), len(fns) - 1)]()


def while_loop(cond_fn, body_fn, loop_vars):
    """layers.while_loop parity: a Python loop, the predicate read on the
    host once per iteration."""
    single = not isinstance(loop_vars, (tuple, list))
    vs = (loop_vars,) if single else tuple(loop_vars)
    while _read(cond_fn(*vs)):
        out = body_fn(*vs)
        vs = (out,) if single else tuple(out)
    return vs[0] if single else list(vs)


def scan(f, init, xs, reverse=False):
    """``lax.scan`` parity: ``f(carry, x_t) -> (carry, y_t)`` over the
    leading axis of ``xs`` (a tensor or a tuple/list/dict of them); returns
    (carry, ys stacked on a new leading axis)."""
    n = _tree_leaves(xs)[0].shape[0]
    order = range(n - 1, -1, -1) if reverse else range(n)
    carry, ys = init, [None] * n
    for t in order:
        carry, ys[t] = f(carry, _tree_map(lambda a: a[t], xs))
    if n == 0:
        return carry, None
    return carry, _tree_map(lambda *a: torch.stack(a), *ys)


def static_rnn(step_fn, inputs, initial_state):
    """StaticRNN parity: inputs [B, T, ...] stepped in time order;
    ``step_fn(state, x_t) -> (new_state, out_t)``; returns (final state,
    outputs [B, T, ...])."""
    final, outs = scan(step_fn, initial_state, torch.swapaxes(inputs, 0, 1))
    return final, _tree_map(lambda o: torch.swapaxes(o, 0, 1), outs)


def dynamic_rnn(step_fn, inputs, initial_state):
    """DynamicRNN parity over a RaggedBatch: the state freezes past each
    row's length (the final state is the state at its last valid step, as
    shrink_rnn_memory_op.cc gives it) and the outputs there are 0."""
    if not isinstance(inputs, RaggedBatch):
        raise TypeError("dynamic_rnn expects a RaggedBatch")
    data, lengths = inputs.data, inputs.lengths

    def body(carry, x_t):
        t, state = carry
        new_state, out_t = step_fn(state, x_t)
        alive = t < lengths

        def sel(new, old):
            return torch.where(alive.reshape((-1,) + (1,) * (new.dim() - 1)),
                               new, old)

        state = _tree_map(sel, new_state, state)
        out_t = _tree_map(lambda o: torch.where(
            alive.reshape((-1,) + (1,) * (o.dim() - 1)), o,
            torch.zeros((), dtype=o.dtype, device=o.device)), out_t)
        return (t + 1, state), out_t

    t0 = torch.zeros((), dtype=torch.int32, device=lengths.device)
    (_, final), outs = scan(body, (t0, initial_state),
                            torch.swapaxes(data, 0, 1))
    outs = _tree_map(lambda o: torch.swapaxes(o, 0, 1), outs)
    return final, RaggedBatch(outs, lengths)
