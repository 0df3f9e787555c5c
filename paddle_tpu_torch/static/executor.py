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
- persistable vars go back to the scope (detached: a ``batch_norm`` op's
  new running stats too), the feeds and fetches are numpy arrays or
  (``return_numpy=False``) tensors on the device, and the scope's
  ``@step@`` counts the runs;
- an op that draws (``_needs_rng``: ``dropout``) gets a generator on the
  device seeded from ``program.random_seed``, the run's ``@step@`` and the
  op's first output name (the counterpart of the JAX executor's per-step
  fold, executor.py:1365-1510: the same seed gives the same masks in two
  executors, and the pass pipeline moves no mask). The forward runs once
  under autograd, so the fetched loss and the grads see one mask;
- fp32 convolutions and matrix products run with cuDNN's and cuBLAS's TF32
  off, so the card computes what the CPU does.

Each (program, version, feed signature, fetch list, passes) gets one
prepared runner, built on first use and kept (with
``FLAGS_executor_fast_path``): the optimized clone, its persistable names
and the kernel libraries its ops reach, built and loaded before its first
step. ``Executor.prepare`` builds it ahead of the first step from arrays
or (shape, dtype) pairs, as the JAX package's AOT warm start does (there
is no XLA compile to warm here: preparing is the pass pipeline and the
kernel builds), and ``trace_count`` counts runner builds. A run pulls
the next batch from every started reader attached to the program whose
vars the feed does not give (``layers.py_reader``'s start/reset protocol;
``EOFException`` at the end), with the JAX checks. Differentiating
through a ``while_block`` is refused, as ``lax.while_loop`` refuses reverse-mode
differentiation; a ``scan_block`` is differentiated through its steps.

Not ported yet, raising :class:`EnforceNotMet` naming the ROADMAP item:
host segments (ops marked ``_host``: parameter-server send/recv, queue 1
item 9), prefetch (``device_prefetch``, ``background_prefetch``,
``Executor.feed_stage``) and ``train_from_dataset`` /
``infer_from_dataset`` (item 10), the persistent compile cache
(``PADDLE_TPU_CACHE_DIR``; item 10), mesh specs
(``CompiledProgram.with_data_parallel`` / ``with_mesh_sharding``; item 9),
and the monitor hooks the JAX executor feeds (goodput, trace, anomaly,
tensorwatch, numerics; item 10).
"""

import threading
import zlib

import numpy as np
import torch

from paddle_tpu_torch.core.dtypes import dtype_name
from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.core.flags import define_flag, get_flag
from paddle_tpu_torch.core.place import place_device
from paddle_tpu_torch.ops.nn import no_tf32
from paddle_tpu_torch.static.backward import GRAD_SUFFIX
from paddle_tpu_torch.static.program import (
    OP_REGISTRY, Program, default_main_program,
)

__all__ = ["Executor", "Scope", "global_scope", "scope_guard", "exec_op",
           "device_prefetch", "background_prefetch"]

define_flag("executor_fast_path", True,
            "Keep the prepared runner (the pass pipeline's optimized "
            "clone, its state names and kernel libraries) per (program, "
            "version, feed signature, fetch list) so a steady-state step "
            "does not re-run the pipeline (0 = prepare every run)")
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


def _op_generator(device, seed, step, op):
    """The generator of a ``_needs_rng`` op in run ``step`` of a program
    seeded ``seed``: a function of the three and of the op's first output
    name, so neither the executor nor the pass pipeline changes it."""
    key = zlib.crc32(op.output_names()[0].encode())
    mixed = ((int(seed) * 0x9E3779B1 + int(step)) * 0x85EBCA77 + key) \
        & ((1 << 63) - 1)
    return torch.Generator(device=device).manual_seed(mixed)


def _interpret(ops, env, rng_for=None):
    """Run ``ops`` in order over ``env``; the ``autodiff`` op makes the
    grads of the summed loss over the ops before it. ``rng_for(op)`` gives
    a ``_needs_rng`` op its generator."""
    def run(op):
        rng = rng_for(op) if rng_for and op.attrs.get("_needs_rng") else None
        env.update(exec_op(op, env, rng))

    ad = next((i for i, op in enumerate(ops) if op.type == "autodiff"), None)
    if ad is None:
        with torch.no_grad():
            for op in ops:
                run(op)
        return env
    adop = ops[ad]
    names = adop.attrs["params"]
    params = {n: env[n] for n in names}
    leaves = {n: p.detach().requires_grad_() for n, p in params.items()}
    env.update(leaves)
    with torch.enable_grad():
        for op in ops[:ad]:
            run(op)
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
            run(op)
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


def _spec_of(v):
    """(shape, dtype name) of a feed: an array, a tensor or a (shape, dtype)
    pair, the currency of ``prepare``."""
    if isinstance(v, tuple) and len(v) == 2 and not hasattr(v, "dtype"):
        shape, dtype = v
        if not isinstance(dtype, torch.dtype):
            dtype = np.dtype(dtype)
        return tuple(int(d) for d in shape), dtype_name(dtype)
    if not hasattr(v, "dtype"):
        v = np.asarray(v)
    return tuple(v.shape), dtype_name(v.dtype)


def _feed_signature(feed):
    return tuple(sorted((k, *_spec_of(v)) for k, v in feed.items()))


def _sub_programs(op):
    return [v for v in op.attrs.values() if isinstance(v, Program)]


def _kernel_libraries(ops):
    """The kernel libraries (``ops/kernels/_build.py``'s names) that
    ``ops``, and the ops of their sub-programs, launch."""
    from paddle_tpu_torch.optimizer import kernel_library
    from paddle_tpu_torch.static.opt_passes import FUSED_MATMUL
    libs = set()
    for op in ops:
        if op.type == "embedding":
            libs.add("embedding")
        elif op.type == FUSED_MATMUL:
            libs.add("fused_matmul")
        elif op.type == "apply_optimizer":
            lib = kernel_library(op.attrs["opt"])
            if lib is not None:
                libs.add(lib)
        for sub in _sub_programs(op):
            libs |= _kernel_libraries(sub.global_block().ops)
    return libs


def _refuse_grad_through_while(ops):
    """The JAX package cannot differentiate through ``lax.while_loop``
    (reverse mode); neither does the port through a ``while_block`` that a
    differentiated value reaches before the ``autodiff`` op."""
    ad = next((i for i, op in enumerate(ops) if op.type == "autodiff"), None)
    if ad is None:
        return
    live = set(ops[ad].attrs["params"])
    for op in ops[:ad]:
        if live.isdisjoint(op.input_names()):
            continue
        if op.type == "while_block":
            raise EnforceNotMet(
                "autodiff through a while_block: reverse-mode "
                "differentiation does not work for a while loop (the JAX "
                "package's lax.while_loop refuses it too); a loop of fixed "
                "length differentiates as layers.static_rnn (scan_block)")
        live.update(op.output_names())


class _Runner:
    """One prepared (program, version, feed signature, fetch list,
    passes): the program to interpret (the pass pipeline's optimized clone,
    or the program itself), its persistable names and the kernel libraries
    its ops launch, built and loaded when it was prepared."""

    def __init__(self, program, kernel_libraries):
        self.program = program
        blk = program.global_block()
        self.ops = list(blk.ops)
        self.state_names = [n for n, v in blk.vars.items() if v.persistable]
        self.kernel_libraries = sorted(kernel_libraries)
        _refuse_grad_through_while(self.ops)


class Executor:
    """Runs Programs on one device: ``place`` (``CPUPlace()``,
    ``CUDAPlace(i)``, a torch device) or, by default, the card
    (``NoCudaDeviceError`` without one)."""

    def __init__(self, place=None):
        self.place = place
        self.device = place_device(place)
        self._runners = {}
        self._trace_count = 0

    @property
    def trace_count(self):
        """The prepared runners this executor built: a steady-state step
        with an unchanged feed signature does not move it."""
        return self._trace_count

    @staticmethod
    def _passes_enabled(compiled):
        """The run's apply_ir_passes: the CompiledProgram's
        ``BuildStrategy.apply_ir_passes`` when set, else the flag."""
        bs = getattr(compiled, "_build_strategy", None)
        if bs is not None and bs.apply_ir_passes is not None:
            return bool(bs.apply_ir_passes)
        return bool(get_flag("apply_ir_passes"))

    @staticmethod
    def _unwrap(program):
        from paddle_tpu_torch.compiler import CompiledProgram
        program = program or default_main_program()
        compiled = program if isinstance(program, CompiledProgram) else None
        if compiled is not None:
            program = compiled._program
        return program, compiled

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True):
        """Run one step; returns the fetches in ``fetch_list`` order, as
        numpy arrays or (``return_numpy=False``) tensors on the device (a
        persistable's is the live tensor, which later steps update in
        place). With no feed, the started readers attached to the program
        give it (``EOFException`` when one is exhausted)."""
        program, compiled = self._unwrap(program)
        feed = dict(feed or {})
        fetch_names = [f if isinstance(f, str) else f.name
                       for f in (fetch_list or [])]
        feed = {**self._pull_readers(program, fetch_names, feed), **feed}
        scope = scope or global_scope()
        if not feed and self._is_startup_like(program):
            self._run_eager(program, scope)
            values = {n: scope.find_var(n) for n in fetch_names}
        else:
            runner = self._runner(program, _feed_signature(feed),
                                  fetch_names, scope,
                                  self._passes_enabled(compiled))
            values = self._run_main(runner, feed, fetch_names, scope)
        return [_fetch_value(n, values[n], return_numpy)
                for n in fetch_names]

    @staticmethod
    def _program_read_names(program):
        """The names the program's ops read, memoized by op count (ops are
        only ever appended)."""
        ops = program.global_block().ops
        cached = getattr(program, "_read_names_cache", None)
        if cached is not None and cached[0] == len(ops):
            return cached[1]
        names = {n for op in ops for n in op.input_names()}
        program._read_names_cache = (len(ops), names)
        return names

    def _pull_readers(self, program, fetch_names, feed):
        """The non-iterable reader protocol (fluid.layers.py_reader's
        start()/reset()): the next batch of every started reader attached
        to the program whose vars it reads and the feed does not give (as
        in Fluid, a run may feed other vars, such as an RNN's initial
        state, beside a reader; the JAX package pulls only when nothing is
        fed). Two started readers feeding one var raise before anything is
        pulled (a chained reader registers itself and its underlying
        py_reader)."""
        started = [r for r in program._py_readers
                   if getattr(r, "_started", False)
                   and not all(v.name in feed for v in r.vars)]
        if not started:
            return {}
        read_names = self._program_read_names(program) | set(fetch_names)
        pull, fed_by = [], {}
        for r in started:
            rnames = {v.name for v in r.vars}
            if read_names and not (rnames & read_names):
                continue
            for n in rnames:
                if n in fed_by:
                    raise EnforceNotMet(
                        f"two started readers would both feed var '{n}' — "
                        f"start only the outermost reader of a chain (e.g. "
                        f"the batch reader, not its underlying py_reader)")
                fed_by[n] = r
            pull.append(r)
        feed = {}
        for r in pull:
            feed.update(r._next_feed())
        return feed

    def prepare(self, program=None, feed=None, fetch_list=None,
                scope=None):
        """Warm start before the first step: build the prepared runner of
        (program, feed signature, fetch list), run the pass pipeline and
        build and load, on the card, every kernel library its ops launch,
        so the first step compiles nothing. ``feed`` maps names to sample
        arrays or (shape, dtype) pairs; only shapes and dtypes matter. The
        startup program must have run (a persistable missing from the scope
        raises). Returns True: every op of the program is prepared."""
        program, compiled = self._unwrap(program)
        fetch_names = [f if isinstance(f, str) else f.name
                       for f in (fetch_list or [])]
        scope = scope or global_scope()
        self._runner(program, _feed_signature(feed or {}), fetch_names,
                     scope, self._passes_enabled(compiled))
        return True

    def _runner(self, program, feed_sig, fetch_names, scope, apply_passes):
        key = (program, program.version, feed_sig, tuple(fetch_names),
               apply_passes)
        runner = self._runners.get(key)
        if runner is None:
            prog = program
            if apply_passes:
                from paddle_tpu_torch.static.opt_passes import \
                    optimize_for_execution
                prog = optimize_for_execution(program, fetch_names)
            libs = _kernel_libraries(prog.global_block().ops)
            runner = _Runner(prog, libs)
            self._check_state(runner, scope)
            if self.device.type == "cuda":
                from paddle_tpu_torch.ops import kernels
                from paddle_tpu_torch.ops.kernels import _build
                for lib in runner.kernel_libraries:
                    _build.load(lib, kernels.LIBRARY_SIGNATURES[lib])
            self._trace_count += 1
            if get_flag("executor_fast_path"):
                self._runners[key] = runner
        return runner

    @staticmethod
    def _check_state(runner, scope):
        missing = [n for n in runner.state_names if scope.find_var(n) is None]
        if missing:
            raise EnforceNotMet(
                f"Persistable vars not initialized: {missing[:5]} — run the "
                f"startup program first (exe.run(startup_program))")

    def _run_main(self, runner, feed, fetch_names, scope):
        prog = runner.program
        self._check_state(runner, scope)
        env = {n: c.to(self.device) for n, c in prog._constants.items()}
        for n in runner.state_names:
            env[n] = scope.find_var(n)
        blk = prog.global_block()
        for k, v in feed.items():
            env[k] = self._as_feed(blk, k, v)
        step = (scope.find_var(_STEP) or 0) + 1
        scope.set_var(_STEP, step)
        with no_tf32():
            env = _interpret(runner.ops, env, lambda op: _op_generator(
                self.device, prog.random_seed, step, op))
        for n in runner.state_names:
            scope.set_var(n, env[n])
        return {n: env.get(n) for n in fetch_names}

    def _as_feed(self, blk, name, value):
        """A feed as a tensor on the device, in its data var's dtype (a
        reader's pinned batch is copied without blocking the host)."""
        t = value if isinstance(value, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(value))
        dtype = blk.vars[name].dtype if blk.has_var(name) else t.dtype
        return t.to(self.device, dtype, non_blocking=True)

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
        self._runners.clear()
