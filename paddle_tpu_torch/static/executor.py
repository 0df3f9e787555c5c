"""Executor and Scope: the port of ``paddle_tpu/static/executor.py``.

Where the JAX Executor traces a block once and runs it as one compiled XLA
computation, the port interprets the block op by op through ``OP_REGISTRY``
on the executor's device, eagerly, as the reference's executor.cc:417 loop
does; each op's compute launches the port's kernels (on the card) or their
plain bodies (on the CPU).

``Executor.run``:

- a startup-like program (no autodiff op, no feed read) runs once, eagerly,
  its initializers drawing from a ``torch.Generator`` seeded from
  ``program.random_seed`` (executor.py:1363-1374);
- a main program first goes through the pass pipeline
  (``static/opt_passes.py``) on a clone, when ``FLAGS_apply_ir_passes`` or
  the CompiledProgram's ``BuildStrategy.apply_ir_passes`` says so
  (executor.py:1393-1403); with ``FLAGS_executor_fast_path`` (on) the
  optimized clone is kept per (program, version, fetch list);
- the ops before the ``autodiff`` op run with the parameters as leaves that
  require grad; the loss is **summed** and differentiated by
  ``torch.autograd.grad`` with respect to the parameters, a parameter the
  loss does not reach getting a zero grad (executor.py:1544-1573); the ops
  after it run under ``no_grad`` and update parameters and slots in place;
- persistable vars go back to the scope, the feeds and fetches are numpy
  arrays or (``return_numpy=False``) tensors on the device, and the scope's
  ``@step@`` counts the runs.

Not ported yet, raising :class:`EnforceNotMet` naming the ROADMAP item:
host segments (ops marked ``_host``: parameter-server send/recv, queue 1
item 9), prefetch (``device_prefetch``, ``background_prefetch``,
``Executor.feed_stage``; item 10), ``Executor.prepare`` (AOT warm start;
item 5), mesh specs (``CompiledProgram.with_data_parallel`` /
``with_mesh_sharding``; item 9), ``train_from_dataset`` /
``infer_from_dataset`` (item 10), and the monitor hooks the JAX executor
feeds (goodput, trace, anomaly, tensorwatch, numerics; item 10).
"""

import threading

import numpy as np
import torch

from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.core.flags import define_flag, get_flag
from paddle_tpu_torch.core.place import place_device
from paddle_tpu_torch.static.backward import GRAD_SUFFIX
from paddle_tpu_torch.static.program import OP_REGISTRY, default_main_program

__all__ = ["Executor", "Scope", "global_scope", "scope_guard", "exec_op",
           "device_prefetch", "background_prefetch"]

define_flag("executor_fast_path", True,
            "Keep the pass pipeline's optimized clone per (program, "
            "version, fetch list) so a steady-state step "
            "does not re-run the pipeline (0 = optimize every run)")
define_flag("apply_ir_passes", True,
            "Run the program-level pass pipeline (static/opt_passes.py: "
            "matmul+bias+act fusion, dead-op elimination) before running "
            "each main program; BuildStrategy.apply_ir_passes overrides it "
            "per program (0 = run the program as built)")

_STEP = "@step@"


class Scope:
    """Name -> value store (framework/scope.h parity)."""

    def __init__(self):
        self._vars = {}

    def var(self, name):
        return self._vars.setdefault(name, None)

    def find_var(self, name):
        return self._vars.get(name)

    def set_var(self, name, value):
        self._vars[name] = value

    def drop_var(self, name):
        self._vars.pop(name, None)

    def names(self):
        return list(self._vars)

    @classmethod
    def from_numpy(cls, arrays, device, program):
        """A scope holding ``arrays`` ({name: numpy array}, e.g. the JAX
        package's scope after its startup program: parameters, optimizer
        slots and step counters) as tensors on ``device``. Strict: the names
        must be exactly ``program``'s persistable vars, each array a numpy
        array of its var's shape and dtype; anything else raises."""
        blk = program.global_block()
        want = {n: v for n, v in blk.vars.items() if v.persistable}
        missing, extra = sorted(set(want) - set(arrays)), \
            sorted(set(arrays) - set(want))
        if missing or extra:
            raise EnforceNotMet(
                f"Scope.from_numpy: the names must be the program's "
                f"persistable vars: missing {missing}, unexpected {extra}")
        scope = cls()
        device = torch.device(device)
        for name, var in want.items():
            a = arrays[name]
            dt = torch.empty((), dtype=var.dtype).numpy().dtype
            if (not isinstance(a, np.ndarray) or a.dtype != dt
                    or a.shape != tuple(var.shape)):
                got = (f"{a.dtype}{list(a.shape)}" if isinstance(a, np.ndarray)
                       else type(a).__name__)
                raise EnforceNotMet(
                    f"Scope.from_numpy: {name!r} must be a {dt} numpy array "
                    f"of shape {list(var.shape)}, got {got}")
            scope.set_var(name, torch.tensor(a).to(device))
        return scope


_global_scope = Scope()


class _ScopeStack(threading.local):
    """Per-thread scope stack rooted at the shared global scope."""

    def __init__(self):
        self.stack = [_global_scope]


_scope_tls = _ScopeStack()


def global_scope():
    return _scope_tls.stack[-1]


class scope_guard:
    def __init__(self, scope):
        self.scope = scope

    def __enter__(self):
        _scope_tls.stack.append(self.scope)
        return self.scope

    def __exit__(self, *exc):
        _scope_tls.stack.pop()


def _not_ported(what, item):
    raise EnforceNotMet(f"{what} is not ported yet (ROADMAP queue 1 item "
                        f"{item})")


def device_prefetch(*args, **kwargs):
    """Not ported yet: raises."""
    _not_ported("device_prefetch", "10 (dataio)")


def background_prefetch(*args, **kwargs):
    """Not ported yet: raises."""
    _not_ported("background_prefetch", "10 (dataio)")


def exec_op(op, env, rng=None):
    """Run one op through ``OP_REGISTRY``: bind its inputs from ``env``,
    return {output name: value}. ``rng`` is the generator of an op marked
    ``_needs_rng``."""
    if op.attrs.get("_host"):
        _not_ported(f"host op {op.type!r} (a host segment)",
                    "9 (parameter server)")
    ins = {slot: [env[n] for n in names] for slot, names in op.inputs.items()}
    attrs = dict(op.attrs)
    if attrs.pop("_needs_rng", False):
        attrs["rng"] = rng
    outs = OP_REGISTRY[op.type](ins, attrs)
    return {n: v for slot, names in op.outputs.items()
            for n, v in zip(names, outs.get(slot, []))}


def _interpret(ops, env):
    """Run ``ops`` in order over ``env``; the ``autodiff`` op makes the
    grads of the summed loss over the ops before it."""
    ad = next((i for i, op in enumerate(ops) if op.type == "autodiff"), None)
    if ad is None:
        with torch.no_grad():
            for op in ops:
                env.update(exec_op(op, env))
        return env
    adop = ops[ad]
    names = adop.attrs["params"]
    params = {n: env[n] for n in names}
    leaves = {n: p.detach().requires_grad_() for n, p in params.items()}
    env.update(leaves)
    with torch.enable_grad():
        for op in ops[:ad]:
            env.update(exec_op(op, env))
        loss = env[adop.attrs["loss"]].sum()
        # a loss that reaches no parameter gives every parameter a zero grad
        grads = (torch.autograd.grad(loss, list(leaves.values()),
                                     allow_unused=True)
                 if loss.requires_grad else [None] * len(names))
    for k, v in env.items():
        if isinstance(v, torch.Tensor) and v.requires_grad:
            env[k] = v.detach()
    env.update(params)
    for n, g in zip(names, grads):
        env[n + GRAD_SUFFIX] = torch.zeros_like(params[n]) if g is None else g
    with torch.no_grad():
        for op in ops[ad + 1:]:
            env.update(exec_op(op, env))
    return env


def _fetch_value(name, v, return_numpy):
    if v is None:
        raise EnforceNotMet(f"fetch target {name!r} was not computed by this "
                            "run and is not in the scope")
    if not return_numpy:
        return v
    if v.dtype == torch.bfloat16:       # numpy has no bfloat16
        v = v.float()
    # a copy: parameters are updated in place by later steps
    return v.detach().to("cpu", copy=True).numpy()


class Executor:
    """Runs Programs on one device: ``place`` (``CPUPlace()``,
    ``CUDAPlace(i)``, a torch device) or, by default, the card
    (``NoCudaDeviceError`` without one)."""

    def __init__(self, place=None):
        self.place = place
        self.device = place_device(place)
        self._optimized = {}

    @staticmethod
    def _passes_enabled(compiled):
        """The run's apply_ir_passes: the CompiledProgram's
        ``BuildStrategy.apply_ir_passes`` when set, else the flag."""
        bs = getattr(compiled, "_build_strategy", None)
        if bs is not None and bs.apply_ir_passes is not None:
            return bool(bs.apply_ir_passes)
        return bool(get_flag("apply_ir_passes"))

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True):
        """Run one step; returns the fetches in ``fetch_list`` order, as
        numpy arrays or (``return_numpy=False``) tensors on the device (a
        persistable's is the live tensor, which later steps update in
        place)."""
        from paddle_tpu_torch.compiler import CompiledProgram
        program = program or default_main_program()
        compiled = program if isinstance(program, CompiledProgram) else None
        if compiled is not None:
            program = compiled._program
        feed = feed or {}
        fetch_names = [f if isinstance(f, str) else f.name
                       for f in (fetch_list or [])]
        scope = scope or global_scope()
        if not feed and self._is_startup_like(program):
            self._run_eager(program, scope)
            values = {n: scope.find_var(n) for n in fetch_names}
        else:
            values = self._run_main(program, feed, fetch_names, scope,
                                    self._passes_enabled(compiled))
        return [_fetch_value(n, values[n], return_numpy)
                for n in fetch_names]

    def _run_main(self, program, feed, fetch_names, scope, apply_passes):
        prog = program
        if apply_passes:
            key = (program, program.version, tuple(fetch_names))
            prog = self._optimized.get(key) \
                if get_flag("executor_fast_path") else None
            if prog is None:
                from paddle_tpu_torch.static.opt_passes import \
                    optimize_for_execution
                prog = optimize_for_execution(program, fetch_names)
                if get_flag("executor_fast_path"):
                    self._optimized[key] = prog
        blk = prog.global_block()
        state_names = [n for n, v in blk.vars.items() if v.persistable]
        env = {n: c.to(self.device) for n, c in prog._constants.items()}
        missing = []
        for n in state_names:
            v = scope.find_var(n)
            if v is None:
                missing.append(n)
            env[n] = v
        if missing:
            raise EnforceNotMet(
                f"Persistable vars not initialized: {missing[:5]} — run the "
                f"startup program first (exe.run(startup_program))")
        for k, v in feed.items():
            env[k] = self._as_feed(blk, k, v)
        scope.set_var(_STEP, (scope.find_var(_STEP) or 0) + 1)
        env = _interpret(list(blk.ops), env)
        for n in state_names:
            scope.set_var(n, env[n])
        return {n: env.get(n) for n in fetch_names}

    def _as_feed(self, blk, name, value):
        """A feed as a tensor on the device, in its data var's dtype."""
        t = value if isinstance(value, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(value))
        dtype = blk.vars[name].dtype if blk.has_var(name) else t.dtype
        return t.to(self.device, dtype)

    def _is_startup_like(self, program):
        blk = program.global_block()
        return all(op.type != "autodiff" for op in blk.ops) and all(
            not (blk.has_var(n) and blk.var(n).is_data)
            for op in blk.ops for n in op.input_names())

    def _run_eager(self, program, scope):
        """The startup program: every op once, the initializers drawing on
        the CPU from one generator seeded from ``program.random_seed``;
        every value goes to the scope on the executor's device."""
        gen = torch.Generator().manual_seed(program.random_seed)
        env = {n: c.to(self.device) for n, c in program._constants.items()}
        env.update({n: scope.find_var(n) for n in scope.names()})
        with torch.no_grad():
            for op in program.global_block().ops:
                env.update({n: v.to(self.device)
                            for n, v in exec_op(op, env, gen).items()})
        for n, v in env.items():
            if v is not None:
                scope.set_var(n, v)

    def prepare(self, *args, **kwargs):
        """Not ported yet: raises."""
        _not_ported("Executor.prepare (AOT warm start)", 5)

    def feed_stage(self, *args, **kwargs):
        """Not ported yet: raises."""
        _not_ported("Executor.feed_stage (prefetch)", "10 (dataio)")

    def train_from_dataset(self, *args, **kwargs):
        """Not ported yet: raises."""
        _not_ported("Executor.train_from_dataset", "10 (dataio)")

    def infer_from_dataset(self, *args, **kwargs):
        """Not ported yet: raises."""
        _not_ported("Executor.infer_from_dataset", "10 (dataio)")

    def close(self):
        self._optimized.clear()
