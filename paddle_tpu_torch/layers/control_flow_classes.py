"""Class-shaped control flow builders: the port of
``paddle_tpu/layers/control_flow_classes.py``.

Parity targets: python/paddle/fluid/layers/control_flow.py: While:630,
StaticRNN:280, DynamicRNN:1700, IfElse:1564, Switch:1436.

As in the JAX package, the looping builders (While, StaticRNN, DynamicRNN)
take the step body as a CALLABLE, and Switch and IfElse keep the
reference's with-block surface. ``While`` runs ``ops.control_flow.
while_loop`` (one host read of the predicate per iteration); the RNNs loop
over time and read nothing on the host (a DynamicRNN row past its length
holds its memory by ``torch.where`` and outputs 0); ``Switch.select``
picks among values already computed, by ``torch.where``, with no host
read; ``IfElse`` partitions rows by its mask, read on the host, as the
JAX package's ``split_lod_tensor`` does.
"""

import torch

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.ops import control_flow as _cf

__all__ = ["While", "Switch", "IfElse", "StaticRNN", "DynamicRNN"]


class While:
    """layers.While parity, callable-body form:

        w = While(cond_fn)               # cond_fn(*loop_vars) -> bool
        out_vars = w(body_fn, loop_vars) # body_fn(*loop_vars) -> new vars
    """

    def __init__(self, cond, is_test=False, name=None):
        enforce(callable(cond),
                "While takes the loop condition as a callable "
                "(cond_fn(*loop_vars) -> bool scalar); a traced block "
                "cannot be re-executed from a with-statement")
        self.cond = cond

    def __call__(self, body, loop_vars):
        return _cf.while_loop(self.cond, body, list(loop_vars))


class Switch:
    """layers.Switch parity:

        with Switch() as switch:
            with switch.case(cond1): out = a
            with switch.case(cond2): out = b
            with switch.default():   out = c
        out = switch.select(a, b, c)

    The value of the first case whose condition holds, else the
    default's, chosen elementwise by ``torch.where``."""

    def __init__(self, name=None):
        self._cases = []
        self._default = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    class _Case:
        def __init__(self, parent, cond):
            self.parent = parent
            self.cond = cond

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    def case(self, condition):
        c = Switch._Case(self, condition)
        self._cases.append(c)
        return c

    def default(self):
        c = Switch._Case(self, None)
        self._default = c
        return c

    def select(self, *values):
        """The value of the first true case; the last value is the
        default()'s, which is required, as in the JAX package."""
        enforce(self._default is not None,
                "Switch.select needs a default() case: under a tracing "
                "regime some branch value must always materialize")
        enforce(len(values) == len(self._cases) + 1,
                "one value per case, plus the default's")
        out = values[-1]
        for c, v in zip(reversed(self._cases), reversed(values[:-1])):
            out = _cf._tree_map(
                lambda a, b, cond=c.cond: torch.where(
                    torch.as_tensor(cond).to(torch.bool), a, b), v, out)
        return out


class IfElse:
    """layers.IfElse parity:

        ie = IfElse(cond)                  # cond: [N] bool mask
        with ie.true_block():
            ie.output(fn_true(ie.input(x)))
        with ie.false_block():
            ie.output(fn_false(ie.input(x)))
        out, = ie()                        # rows merged back in order

    Each block sees only its rows (split_lod_tensor / merge_lod_tensor)."""

    def __init__(self, cond, name=None):
        self.cond = torch.as_tensor(cond).reshape(-1).to(torch.bool)
        self._in_true = None
        self._outputs = {True: [], False: []}
        self._restore = None

    class _Branch:
        def __init__(self, parent, flag):
            self.parent = parent
            self.flag = flag

        def __enter__(self):
            self.parent._in_true = self.flag
            return self

        def __exit__(self, *exc):
            self.parent._in_true = None
            return False

    def true_block(self):
        return IfElse._Branch(self, True)

    def false_block(self):
        return IfElse._Branch(self, False)

    def input(self, x):
        """The rows of ``x`` that belong to the current branch."""
        enforce(self._in_true is not None,
                "IfElse.input() only inside true_block()/false_block()")
        from paddle_tpu_torch.ops.tensor_array import split_lod_tensor
        t, f, restore = split_lod_tensor(x, self.cond)
        self._restore = restore
        return t if self._in_true else f

    def output(self, *outs):
        enforce(self._in_true is not None,
                "IfElse.output() only inside true_block()/false_block()")
        self._outputs[self._in_true].extend(outs)

    def __call__(self):
        from paddle_tpu_torch.ops.tensor_array import merge_lod_tensor
        ts, fs = self._outputs[True], self._outputs[False]
        enforce(len(ts) == len(fs),
                "true and false blocks must emit the same outputs")
        enforce(self._restore is not None,
                "IfElse blocks must read their rows via ie.input(x) "
                "before ie.output(...) — outputs built from unpartitioned "
                "tensors cannot be row-merged")
        return [merge_lod_tensor(t, f, self._restore)
                for t, f in zip(ts, fs)]


class StaticRNN:
    """layers.StaticRNN parity, callable-step form:

        rnn = StaticRNN()
        rnn.step_input(x)                    # [B, T, D] (or several)
        h = rnn.memory(init=h0)
        def step(x_t, h_prev):
            h_new = cell(x_t, h_prev)
            return {"mem": [h_new], "out": [h_new]}
        outs = rnn(step)                     # [[B, T, H], ...]
    """

    def __init__(self, name=None):
        self._inputs = []
        self._mems = []

    def step_input(self, x):
        self._inputs.append(torch.as_tensor(x))
        return x

    def memory(self, init=None, shape=None, batch_ref=None, value=0.0,
               dtype=torch.float32):
        if init is None:
            enforce(batch_ref is not None and shape is not None,
                    "memory needs init= or (shape=, batch_ref=)")
            ref = torch.as_tensor(batch_ref)
            init = torch.full((ref.shape[0],) + tuple(shape), value,
                              dtype=dtype, device=ref.device)
        self._mems.append(torch.as_tensor(init))
        return init

    def _scan(self, body):
        enforce(bool(self._inputs), "call step_input() first")
        xs = tuple(torch.movedim(x, 1, 0) for x in self._inputs)
        T = xs[0].shape[0]
        ts = torch.arange(T, device=xs[0].device)
        _, outs = _cf.scan(body, tuple(self._mems), (ts, xs))
        return [] if outs is None else [torch.movedim(o, 0, 1) for o in outs]

    def __call__(self, step):
        def body(mems, scan_in):
            res = step(*scan_in[1], *mems)
            return tuple(res["mem"]), tuple(res.get("out", ()))
        return self._scan(body)


class DynamicRNN(StaticRNN):
    """layers.DynamicRNN parity: a StaticRNN with per-sequence lengths;
    steps beyond a sequence's length hold its memory and zero its
    outputs."""

    def __init__(self, lengths=None, name=None):
        super().__init__(name)
        self.lengths = None if lengths is None else torch.as_tensor(lengths)

    def __call__(self, step):
        def body(mems, scan_in):
            t, xts = scan_in
            res = step(*xts, *mems)
            new_mems = tuple(res["mem"])
            outs = tuple(res.get("out", ()))
            if self.lengths is not None:
                alive = t < self.lengths.to(t.device)

                def shaped(v):
                    return alive.reshape((-1,) + (1,) * (v.dim() - 1))
                new_mems = tuple(torch.where(shaped(n), n, o)
                                 for n, o in zip(new_mems, mems))
                outs = tuple(o * shaped(o).to(o.dtype) for o in outs)
            return new_mems, outs
        return self._scan(body)
