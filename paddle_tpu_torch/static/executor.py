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
- an op that draws (``_needs_rng``: ``dropout``,
  ``sampled_softmax_with_cross_entropy``) gets a generator on the
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

Host ops (marked ``_host``): ``py_func`` runs between the device ops, its
function called on numpy copies and its outputs put back on the device; a
host op that a differentiated value reaches before the ``autodiff`` op
raises, as in the JAX package (gradients cannot cross the host). A
*segment* is a run of device ops between host ops, as the JAX package cuts
its compiled segments.

The monitor hooks sit at the JAX package's seams (executor.py:297-317,
:828-980), each one check of its module's switch when its monitor is off:
the ``executor/step`` trace with its ``prepare``/``dispatch``/``fetch``
spans (``monitor.trace``), the profiler's ``executor.run/*`` events, the
step metrics (``executor_steps_total``, ``executor_step_ms``,
``executor_fetch_ms``, ``executor_retraces_total``), the goodput ledger
(a runner build is its ``compile``, a reader pull its ``input_wait``),
``anomaly.DETECTOR.observe`` of the step time, the flight recorder's step
note, tensor watch's ``@watch@stats`` fetched and peeled off before the
user sees the fetches, ``memory.handle_oom`` on a dispatch OOM, and on
each runner's first step (``FLAGS_monitor_cost``) the cost monitor's
abstract pass, queued to run when its numbers are first read, and the
measured peak of the step on the card. Under
``FLAGS_check_nan_inf`` the step runs on clones of the persistables, one
device flag per segment says whether every float tensor it wrote is
finite, and the flags are read once before the new state reaches the
scope: a trip leaves the scope bitwise at its pre-step values and raises
``monitor.numerics.NonFiniteError`` from the localizer's replay.

Not ported yet, raising :class:`EnforceNotMet` naming the ROADMAP item: the
other host ops (parameter-server send/recv, queue 1 item 9), prefetch
(``device_prefetch``, ``background_prefetch``, ``Executor.feed_stage``) and
``train_from_dataset`` / ``infer_from_dataset`` (item 10), the persistent
compile cache (``PADDLE_TPU_CACHE_DIR``; item 10 step 3) and mesh specs
(``CompiledProgram.with_data_parallel`` / ``with_mesh_sharding``; item 9).
"""

import itertools
import threading
import time
import zlib

import numpy as np
import torch

from paddle_tpu_torch.core.dtypes import dtype_name
from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.core.flags import define_flag, get_flag
from paddle_tpu_torch.core.place import place_device
from paddle_tpu_torch.monitor import anomaly as _anomaly
from paddle_tpu_torch.monitor import flight_recorder as _flight
from paddle_tpu_torch.monitor import goodput as _goodput
from paddle_tpu_torch.monitor import tensorwatch as _tensorwatch
from paddle_tpu_torch.monitor import trace as _trace
from paddle_tpu_torch.monitor.registry import counter as _counter
from paddle_tpu_torch.monitor.registry import histogram as _histogram
from paddle_tpu_torch.ops.nn import no_tf32
from paddle_tpu_torch.profiler import RecordEvent
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
define_flag("monitor_cost", True,
            "On each prepared runner's first step, queue the count of its "
            "FLOPs and bytes (monitor/cost.py's abstract pass on meta "
            "copies, run when first read) and, on the card, measure its "
            "peak memory (monitor/memory.py) (0 = skip the probe)")
define_flag("pass_cost_evidence", False,
            "Count the FLOPs and bytes (monitor/cost.py's abstract pass) "
            "before the pass pipeline and after every pass, publishing "
            "per-pass predicted deltas (program_pass_flops_delta / "
            "_bytes_delta gauges and the pass_evidence table); evidence "
            "tooling, off by default")

# the hot-loop metrics (monitor/registry.py), under the JAX names
_m_steps = _counter("executor_steps_total",
                    "Executor.run calls that dispatched a step")
_m_step_ms = _histogram("executor_step_ms",
                        "Wall ms per Executor.run call (prepare + "
                        "dispatch + fetch)")
_m_fetch_ms = _histogram("executor_fetch_ms",
                         "Wall ms blocked materializing fetches "
                         "(host sync) per Executor.run call")
_m_retraces = _counter("executor_retraces_total",
                       "Device-segment traces performed (mirrors "
                       "Executor.trace_count across all executors)")

_STEP = "@step@"
_flow_ids = itertools.count(1)
_runner_ids = itertools.count(1)


class Scope:
    """Name -> value store (framework/scope.h parity). ``version`` counts
    changes of the name set (a var created or dropped), not value updates
    (static/executor.py:116-148)."""

    def __init__(self):
        self._vars = {}
        self._version = 0

    @property
    def version(self):
        return self._version

    def var(self, name):
        if name not in self._vars:
            self._version += 1
        return self._vars.setdefault(name, None)

    def find_var(self, name):
        return self._vars.get(name)

    def set_var(self, name, value):
        if name not in self._vars:
            self._version += 1
        self._vars[name] = value

    def drop_var(self, name):
        if name in self._vars:
            self._version += 1
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


#: the host ops (``_host``) the port runs
_HOST_OPS = frozenset({"py_func"})


def exec_op(op, env, rng=None):
    """Run one op through ``OP_REGISTRY``: bind its inputs from ``env``,
    return {output name: value}. ``rng`` is the generator of an op marked
    ``_needs_rng``."""
    if op.attrs.get("_host") and op.type not in _HOST_OPS:
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


def _interpret(ops, env, rng_for=None, after_op=None):
    """Run ``ops`` in order over ``env``; the ``autodiff`` op makes the
    grads of the summed loss over the ops before it. ``rng_for(op)`` gives
    a ``_needs_rng`` op its generator; ``after_op(i, op, outs)`` sees each
    op's outputs once ``env`` holds them (the ``autodiff`` op's are its
    ``<param>@GRAD`` leaves)."""
    def run(i, op):
        rng = rng_for(op) if rng_for and op.attrs.get("_needs_rng") else None
        outs = exec_op(op, env, rng)
        env.update(outs)
        if after_op is not None:
            after_op(i, op, outs)

    ad = next((i for i, op in enumerate(ops) if op.type == "autodiff"), None)
    if ad is None:
        with torch.no_grad():
            for i, op in enumerate(ops):
                run(i, op)
        return env
    adop = ops[ad]
    names = adop.attrs["params"]
    params = {n: env[n] for n in names}
    leaves = {n: p.detach().requires_grad_() for n, p in params.items()}
    env.update(leaves)
    with torch.enable_grad():
        for i, op in enumerate(ops[:ad]):
            run(i, op)
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
    if after_op is not None:
        after_op(ad, adop, {n + GRAD_SUFFIX: env[n + GRAD_SUFFIX]
                            for n in names})
    with torch.no_grad():
        for i, op in enumerate(ops[ad + 1:], ad + 1):
            run(i, op)
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


def _run_fetch(program, fetch_names):
    """The fetch list a step runs: a tensor-watch program's
    ``@watch@stats`` rides it (executor.py:1164-1170)."""
    if (program.global_block().has_var(_tensorwatch.STATS_VAR)
            and _tensorwatch.STATS_VAR not in fetch_names):
        return list(fetch_names) + [_tensorwatch.STATS_VAR]
    return list(fetch_names)


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


def _refuse_host_in_grad(ops):
    """A host op before the ``autodiff`` op whose outputs are not only
    parameters would cut the gradient of everything upstream of it: raise,
    as the JAX Executor does (executor.py:1455-1473)."""
    ad = next((i for i, op in enumerate(ops) if op.type == "autodiff"), None)
    if ad is None:
        return
    roots = set(ops[ad].attrs["params"])
    for i, op in enumerate(ops[:ad]):
        outs = set(op.output_names())
        if op.attrs.get("_host") and (not outs or not outs <= roots):
            raise EnforceNotMet(
                f"host op {op.type!r} at position {i} feeds the "
                f"differentiated forward region — gradients cannot flow "
                f"through a host boundary, so every parameter upstream of "
                f"it would silently stop training. Move it after the "
                f"loss/backward, or use a differentiable op instead")


def _segments(ops):
    """[(is_host, start, end)]: the runs of ops with the same ``_host``
    mark, the JAX package's segments (executor.py:1482-1489)."""
    segs, i = [], 0
    while i < len(ops):
        is_host = bool(ops[i].attrs.get("_host"))
        j = i
        while j < len(ops) and bool(ops[j].attrs.get("_host")) == is_host:
            j += 1
        segs.append((is_host, i, j))
        i = j
    return segs


def _writes(op):
    if op.type == "autodiff":
        return [n + GRAD_SUFFIX for n in op.attrs["params"]]
    return op.output_names()


class _Runner:
    """One prepared (program, version, feed signature, fetch list,
    passes): the program to interpret (the pass pipeline's optimized clone,
    or the program itself), its persistable names and the kernel libraries
    its ops launch, built and loaded when it was prepared, and its segments
    with the names each device segment writes (the numerics sentinels'
    scope)."""

    def __init__(self, program, kernel_libraries, device):
        self.program = program
        self.device = device
        blk = program.global_block()
        self.ops = list(blk.ops)
        self.state_names = [n for n, v in blk.vars.items() if v.persistable]
        self.kernel_libraries = sorted(kernel_libraries)
        self.segs = _segments(self.ops)
        self.seg_writes = {hi - 1: sorted({n for op in self.ops[lo:hi]
                                           for n in _writes(op)})
                           for is_host, lo, hi in self.segs if not is_host}
        self.uid = next(_runner_ids)
        self.cost_done = False
        _refuse_grad_through_while(self.ops)
        _refuse_host_in_grad(self.ops)

    def constants(self):
        return {n: c.to(self.device)
                for n, c in self.program._constants.items()}

    def replay(self, state, feeds, base_key, step_idx, end, after_op):
        """Re-run ``ops[:end]`` of run ``step_idx`` (the JAX step index:
        ``@step@`` before the run) from clones of ``state`` with ``feeds``,
        every op that draws drawing what it drew in that run;
        ``after_op(i, op, outs)`` sees each op (the numerics localizer)."""
        env = self.constants()
        env.update({n: v.clone() if isinstance(v, torch.Tensor) else v
                    for n, v in state.items()})
        env.update(feeds)
        with no_tf32():
            _interpret(self.ops[:end], env, lambda op: _op_generator(
                self.device, base_key, step_idx + 1, op), after_op)


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
        if _goodput._armed:
            # blocked on a reader's queue: the input pipeline could not
            # keep up, the goodput ledger's input_wait (executor.py:297-305)
            t_pull = time.perf_counter()
            pulled = self._pull_readers(program, fetch_names, feed)
            if pulled:
                _goodput.attribute(time.perf_counter() - t_pull,
                                   phase="input_wait")
        else:
            pulled = self._pull_readers(program, fetch_names, feed)
        feed = {**pulled, **feed}
        scope = scope or global_scope()
        if not feed and self._is_startup_like(program):
            self._run_eager(program, scope)
            return [_fetch_value(n, scope.find_var(n), return_numpy)
                    for n in fetch_names]
        return self._run_step(program, compiled, feed, fetch_names, scope,
                              return_numpy)

    def _run_step(self, program, compiled, feed, fetch_names, scope,
                  return_numpy):
        """One step of a main program with the monitor hooks at the JAX
        package's seams (executor.py:828-980)."""
        t_run = time.perf_counter()
        if _goodput._armed:
            _goodput.on_run_start(t_run)
        tc0 = self._trace_count
        tctx = _trace.start_trace("executor/step", current=True) \
            if _trace._enabled else None
        if tctx is not None:
            tctx.t0 = t_run
        try:
            with RecordEvent("executor.run/prepare"):
                # a tensor-watch program's stats ride the fetch list, peeled
                # off before the user sees the fetches
                run_fetch = _run_fetch(program, fetch_names)
                watch = len(run_fetch) > len(fetch_names)
                runner = self._runner(program, _feed_signature(feed),
                                      run_fetch, scope,
                                      self._passes_enabled(compiled))
            t_prep = time.perf_counter()
            if tctx is not None:
                _trace.record_span(tctx, "executor/prepare", t_run, t_prep)
            step_idx = int(scope.find_var(_STEP) or 0)
            scope.set_var(_STEP, step_idx + 1)
            if tctx is not None:
                tctx.attrs["step"] = step_idx
            check = bool(get_flag("check_nan_inf"))
            fid = next(_flow_ids)
            t_disp = time.perf_counter()
            with RecordEvent("executor.run/dispatch", args={"flow": fid}):
                try:
                    env, feeds, flags = self._run_main(
                        runner, feed, scope, step_idx, check)
                except Exception as e:
                    from paddle_tpu_torch.monitor import memory as _memory
                    if _memory.is_oom_error(e):
                        _memory.handle_oom(e, "executor.run/dispatch",
                                           step=step_idx)
                    raise
            t_disp_end = time.perf_counter()
            if tctx is not None:
                _trace.record_span(tctx, "executor/dispatch", t_disp,
                                   t_disp_end)
            if check and flags:
                # the one host read of the checked mode, before the new
                # state reaches the scope
                from paddle_tpu_torch.monitor import numerics as _numerics
                ok = _numerics.read_flags(flags)
                if not all(ok):
                    del env
                    _numerics.handle_trip(
                        runner, {n: scope.find_var(n)
                                 for n in runner.state_names},
                        feeds, runner.program.random_seed, step_idx,
                        ok.index(False))
            for n in runner.state_names:
                scope.set_var(n, env[n])
            watch_v = env.get(_tensorwatch.STATS_VAR) if watch else None
            if return_numpy:
                with RecordEvent("executor.run/fetch", args={"flow": fid}):
                    t_fetch = time.perf_counter()
                    out = [_fetch_value(n, env.get(n), True)
                           for n in fetch_names]
                    _m_fetch_ms.observe(
                        (time.perf_counter() - t_fetch) * 1e3)
                if tctx is not None:
                    _trace.record_span(tctx, "executor/fetch", t_fetch,
                                       time.perf_counter())
            else:
                out = [_fetch_value(n, env.get(n), False)
                       for n in fetch_names]
            _m_steps.inc()
            step_ms = (time.perf_counter() - t_run) * 1e3
            _m_step_ms.observe(step_ms)
            if _goodput._armed:
                _goodput.on_run_end(t_run, t_prep, t_disp, t_disp_end,
                                    self._trace_count > tc0)
            if watch_v is not None and _tensorwatch._enabled:
                _tensorwatch.on_step(watch_v, step_idx, sync=return_numpy)
            if _anomaly._enabled:
                # keyed by runner: train and eval programs through one
                # executor get separate stall baselines
                _anomaly.DETECTOR.observe(step=step_idx, step_ms=step_ms,
                                          step_ms_key=runner.uid)
            if _flight._enabled:
                _flight.RECORDER.note("step", "executor.run", step=step_idx)
            if tctx is not None:
                _trace.record_exemplar("executor_step_ms", step_ms, tctx)
                _trace.end_trace(tctx)
            return out
        except BaseException:
            # a step that dies mid-flight (an op, a sentinel trip, the
            # fetch) still ends its trace as an error
            if tctx is not None:
                _trace.end_trace(tctx, error=True)
            raise

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
        fetch_names = _run_fetch(program, [
            f if isinstance(f, str) else f.name for f in (fetch_list or [])])
        scope = scope or global_scope()
        runner = self._runner(program, _feed_signature(feed or {}),
                              fetch_names, scope,
                              self._passes_enabled(compiled))
        # the memory ledger's residency of the scope (executor.py:1040-1056):
        # optimizer slots are "<param>@<slot>" and internal optimizer state
        # leads with "@"; everything else is a parameter
        from paddle_tpu_torch.monitor import memory as _memory
        p_bytes = s_bytes = 0
        for n in runner.state_names:
            v = scope.find_var(n)
            nb = v.numel() * v.element_size() \
                if isinstance(v, torch.Tensor) else 0
            if "@" in n:
                s_bytes += nb
            else:
                p_bytes += nb
        _memory.ledger_set("train/params", p_bytes)
        if s_bytes:
            _memory.ledger_set("train/optimizer_slots", s_bytes)
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
                probe = None
                if get_flag("pass_cost_evidence"):
                    probe = self._cost_probe(feed_sig, scope)
                prog = optimize_for_execution(program, fetch_names,
                                              cost_probe=probe)
            libs = _kernel_libraries(prog.global_block().ops)
            runner = _Runner(prog, libs, self.device)
            self._check_state(runner, scope)
            if self.device.type == "cuda":
                from paddle_tpu_torch.ops import kernels
                from paddle_tpu_torch.ops.kernels import _build
                for lib in runner.kernel_libraries:
                    _build.load(lib, kernels.LIBRARY_SIGNATURES[lib])
            self._trace_count += 1
            _m_retraces.inc()
            if get_flag("executor_fast_path"):
                self._runners[key] = runner
        return runner

    def _cost_probe(self, feed_sig, scope):
        """``FLAGS_pass_cost_evidence``'s probe: the cost monitor's abstract
        pass over a program's first device segment, on meta tensors of the
        scope's state and of the feed signature's shapes and dtypes."""
        from paddle_tpu_torch.core.dtypes import convert_dtype
        from paddle_tpu_torch.monitor import cost as _cost
        feeds = {n: torch.empty(shape, dtype=convert_dtype(dt), device="meta")
                 for n, shape, dt in feed_sig}

        def probe(prog):
            blk = prog.global_block()
            env = {n: c for n, c in prog._constants.items()}
            env.update({n: scope.find_var(n) for n, v in blk.vars.items()
                        if v.persistable})
            env.update(feeds)
            is_host, _lo, hi = (_segments(blk.ops) or [(True, 0, 0)])[0]
            if is_host:
                return None
            return _cost.analyze_step(blk.ops[:hi], env, _interpret)
        return probe

    @staticmethod
    def _check_state(runner, scope):
        missing = [n for n in runner.state_names if scope.find_var(n) is None]
        if missing:
            raise EnforceNotMet(
                f"Persistable vars not initialized: {missing[:5]} — run the "
                f"startup program first (exe.run(startup_program))")

    def _run_main(self, runner, feed, scope, step_idx, check):
        """Interpret the runner's ops for run ``step_idx``; returns (env,
        the feeds as tensors, the segments' finiteness flags under
        ``check``). With ``check`` the persistables are clones, so nothing
        reaches the scope until the caller has read the flags."""
        self._check_state(runner, scope)
        env = runner.constants()
        state = {n: scope.find_var(n) for n in runner.state_names}
        if check:
            from paddle_tpu_torch.monitor import numerics
            state = numerics.snapshot(state)
        env.update(state)
        blk = runner.program.global_block()
        feeds = {k: self._as_feed(blk, k, v) for k, v in feed.items()}
        env.update(feeds)
        first = not runner.cost_done and bool(get_flag("monitor_cost"))
        if first:
            self._record_cost(runner, env)
        # the first step's measured peak (memory.py's per-step analysis),
        # read off the process-wide high without resetting it: a caller may
        # be measuring its own peak around this run
        measure = first and self.device.type == "cuda"
        if measure:
            high = torch.cuda.max_memory_allocated(self.device)
            start = torch.cuda.memory_allocated(self.device)
            arg = sum(v.numel() * v.element_size() for v in env.values()
                      if isinstance(v, torch.Tensor))
        flags = []
        after_op = None
        if check:
            ends = runner.seg_writes

            def after_op(i, op, outs):
                if i in ends:
                    flags.append(numerics.sentinel(
                        [env[n] for n in ends[i] if n in env], self.device))
        seed = runner.program.random_seed
        with no_tf32():
            env = _interpret(runner.ops, env, lambda op: _op_generator(
                self.device, seed, step_idx + 1, op), after_op)
        if measure:
            # a step under an earlier high is not measured
            peak = torch.cuda.max_memory_allocated(self.device)
            if peak > high:
                from paddle_tpu_torch.monitor import memory as _memory
                _memory.record_segment_memory(
                    runner.uid, 0, _memory.analyze_compiled({
                        "argument_bytes": arg, "start_bytes": start,
                        "peak_bytes": peak}))
        return env, feeds, flags

    @staticmethod
    def _record_cost(runner, env):
        """Queue the cost monitor's abstract pass over the runner's first
        device segment (the ops before its first host op) on meta copies
        of ``env``: it runs when a reader first asks (monitor/cost.py);
        never fatal. Latched once queued."""
        from paddle_tpu_torch.monitor import cost as _cost
        runner.cost_done = True
        is_host, lo, hi = runner.segs[0] if runner.segs else (True, 0, 0)
        if is_host:
            return
        _cost.defer_step(runner.uid, 0, runner.ops[:hi], env, _interpret)
        # one card: no collective
        _cost.record_segment_comm(runner.uid, 0, {"comm_bytes": 0.0})

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
