"""The port's public surface against the reference's, on the CPU, with no
JAX import: every ``paddle_tpu.`` name of ``tools/api_spec.txt`` that
resolves under ``paddle_tpu_torch.`` must have the reference's signature,
and the repairs of ROADMAP queue 3 (F1-F3, F5-F7) hold.

A signature matches when the port's parameters, ``self`` dropped, start
with the reference's (names, kinds and defaults, as ``inspect`` prints
them); the port may add trailing parameters with defaults (``device=``),
since a call written for the reference still binds; a torch dtype at the
root stands for the JAX dtype constant (a numpy scalar type, printed as
its constructor). Skipped: the port's
``(*args, **kwargs)`` stubs of what is not ported yet (they raise
``EnforceNotMet`` naming their ROADMAP item) and the internal
``serving.Replica`` / ``ReplicaPool``, whose constructors take the port's
own executables.
"""

import importlib
import inspect
import os
import re
import sys

import pytest
import torch

import paddle_tpu_torch as tpt
from paddle_tpu_torch import ops
from paddle_tpu_torch.core.enforce import EnforceNotMet

_TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")
sys.path.insert(0, _TOOLS)
import print_signatures  # noqa: E402

SPEC = os.path.join(_TOOLS, "api_spec.txt")
#: spec names the port resolves: 254 before ``paddle_tpu_torch.ops``
#: star-exported its op modules, 297 after, 318 with the schedules,
#: regularizers and clips, 354 with the monitor's re-exports (28) and
#: ``distributed.SparseEmbeddingTable`` (8), 482 with the ten optimizer
#: rules and their aliases (100), ModelAverage and ExponentialMovingAverage
#: (11), the book models' ops (7) and layers (8) and ``initializer.MSRA``
#: (2), 564 with the sequence, CRF and recurrent ops and ``sums`` under
#: ``ops`` and ``layers``, ``layers.create_parameter``, the ``nn`` module
#: context and ``lod_tensor``'s two names (82), 942 with every function of
#: the four core op modules, control flow and tensor arrays under ``ops``
#: and ``layers``, the control-flow classes, ``layers.io``, ``backward``,
#: ``reader``, ``dataio``'s ``DataFeeder`` and ``PyReader``, the root's
#: ``DataFeeder`` and ``batch``, ``io.batch`` and
#: ``Executor.prepare``/``trace_count`` (378), 1013 with the 30 detection
#: functions and the 5 interpolation functions under ``ops`` and ``layers``
#: and ``layers.multi_box_head`` (71), 1096 with the 21 names of the F10
#: repair, the rest of ``ops/nn.py`` under ``ops`` and ``layers`` (47), the
#: metric ops under both (10) and the rest of ``initializer`` (5), 1200
#: with the random ops, ``ops/misc.py`` and the CTC ops under ``ops`` and
#: ``layers`` (52 each), 1296 with ``ops/quantize.py`` and
#: ``ops/aliases.py`` under ``ops`` and ``layers`` (19 each), ``layers``'
#: own functions and ``OP_REGISTRY`` (9), ``contrib.quant`` (12), the three
#: passes and ``PipelineReport.as_dict`` (7), the root's dtypes, places,
#: ``flags``, ``ExecutionStrategy`` and ``in_dygraph_mode`` (26) and
#: ``static``'s ``ExecutionStrategy``, ``name_scope``,
#: ``static_mode_guard`` and ``Scope.version`` (4), 1358 with the rest of
#: ``serving`` (42: the hot swap, the front door, the swap watchdog, the
#: tenant fair share, ``Replica.join``) and ``monitor``'s
#: ``ThreadedHTTPServerBase``, ``OutOfDeviceMemoryError``,
#: ``merge_rank_traces``, the registry's readers and the rest of ``Tracer``
#: (20), 1556 with the eager surface: ``nn``'s 20 Layer classes (100),
#: ``metrics`` (37), ``distributions`` (25), ``amp`` (12), ``io``'s four
#: eager checkpoint functions, the root's ``grad``, ``no_grad``,
#: ``to_variable`` and ``WeightNormParamAttr`` (5 with its ``to_attr``),
#: ``layers.WeightNormParamAttr`` (2) and ``parallel``'s process
#: environment (13), 1594 with the observability surface: ``monitor``'s
#: exporter, flight recorder, anomaly detector, numerics and tensor watch
#: (29) and ``profiler`` (9); only rises
RESOLVED_FLOOR = 1594
SKIPPED = ("paddle_tpu.serving.Replica", "paddle_tpu.serving.ReplicaPool")
#: the spec's text of a JAX dtype constant (a numpy scalar type's
#: constructor), which the port's torch dtype stands for
_JAX_SCALAR_TYPE = "(self, /, *args, **kwargs)"
_STUB = re.compile(r"^\((self, )?\*args, \*\*kwargs\)$")


def _spec():
    """[(spec module, name, signature text)]; the module is the longest
    of ``print_signatures.MODULES`` the name lies under."""
    mods = sorted(print_signatures.MODULES, key=len, reverse=True)
    out = []
    with open(SPEC) as f:
        for line in f.read().splitlines():
            name, rest = re.match(r"^([\w.]+)(.*)$", line).groups()
            mod = next(m for m in mods if name.startswith(m + "."))
            out.append((mod, name, rest))
    return out


def _resolve(name):
    """The port's object for a ``paddle_tpu.`` name, or None. Class
    attributes are read statically, as the spec's printer reads them."""
    obj = tpt
    for part in name.split(".")[1:]:
        if inspect.ismodule(obj):
            try:
                obj = importlib.import_module(f"{obj.__name__}.{part}")
                continue
            except ImportError:
                pass
        if inspect.isclass(obj):
            obj = inspect.getattr_static(obj, part, None)
        else:
            obj = getattr(obj, part, None)
        if obj is None:
            return None
    return obj


def _params(text):
    """A signature's text, ``self`` dropped, and a default that is a JAX
    dtype or function written as the port's counterpart prints:
    ``<class 'jax.numpy.float32'>`` as ``torch.float32``, and ``jnp.tanh``
    (``<PjitFunction of <function tanh ...>>``) and ``torch.tanh``
    (``<built-in method tanh ...>``) both as ``<function tanh>``; an
    annotation ``jax.Array`` as ``torch.Tensor``."""
    text = re.sub(r"<class 'jax\.numpy\.(\w+)'>", r"torch.\1", text)
    text = text.replace(": jax.Array", ": torch.Tensor")
    text = re.sub(r"<PjitFunction of <function (\w+) at 0x[0-9a-fA-F.]+>>"
                  r"|<built-in method (\w+) of type object at "
                  r"0x[0-9a-fA-F.]+>",
                  lambda m: f"<function {m.group(1) or m.group(2)}>", text)
    return re.sub(r"^\(self(, |\))", lambda m: "(" if m.group(1) == ", "
                  else "()", text)


def _port_text(obj):
    if isinstance(obj, torch.dtype):
        return _JAX_SCALAR_TYPE, None
    if isinstance(obj, property):
        return " [property]", None
    if isinstance(obj, (staticmethod, classmethod)):
        obj = obj.__func__
    if inspect.isclass(obj):
        obj = obj.__init__
    if not callable(obj):
        return "", None
    try:
        sig = inspect.signature(obj)
    except (TypeError, ValueError):
        return "(...)", None
    return str(sig), sig


def _matches(want, obj):
    """Whether the port's ``obj`` has the spec's signature ``want``, up to
    trailing port parameters with defaults."""
    text, sig = _port_text(obj)
    if _params(text) == _params(want):
        return True
    if sig is None:
        return False
    ps = list(sig.parameters.values())
    while ps and ps[-1].default is not inspect.Parameter.empty:
        ps.pop()
        cut = re.sub(r" at 0x[0-9a-fA-F]+", " at 0x...",
                     str(sig.replace(parameters=ps)))
        if _params(cut) == _params(want):
            return True
    return False


def _module_rows(module):
    return [(name, want) for mod, name, want in _spec() if mod == module]


PORTED_MODULES = ("paddle_tpu", "paddle_tpu.layers", "paddle_tpu.ops",
                  "paddle_tpu.nn",
                  "paddle_tpu.optimizer", "paddle_tpu.static",
                  "paddle_tpu.static.opt_passes", "paddle_tpu.io",
                  "paddle_tpu.initializer", "paddle_tpu.inference",
                  "paddle_tpu.serving", "paddle_tpu.clip",
                  "paddle_tpu.regularizer", "paddle_tpu.monitor",
                  "paddle_tpu.distributed", "paddle_tpu.reader",
                  "paddle_tpu.backward", "paddle_tpu.dataio",
                  "paddle_tpu.contrib.quant", "paddle_tpu.metrics",
                  "paddle_tpu.distributions", "paddle_tpu.amp",
                  "paddle_tpu.parallel", "paddle_tpu.profiler")


@pytest.mark.parametrize("module", PORTED_MODULES)
def test_resolved_names_have_the_reference_signatures(module):
    resolved, wrong = 0, []
    for name, want in _module_rows(module):
        obj = _resolve(name)
        if obj is None:
            continue
        resolved += 1
        if name.startswith(SKIPPED) or _STUB.match(_port_text(obj)[0]):
            continue
        if not _matches(want, obj):
            wrong.append(f"{name}: reference {want}, port "
                         f"{_port_text(obj)[0]}")
    assert resolved > 0, f"the port resolves no name of {module}"
    assert not wrong, "\n".join(wrong)


def test_resolved_count_does_not_fall():
    resolved = sum(_resolve(name) is not None for _, name, _ in _spec())
    assert resolved >= RESOLVED_FLOOR, (resolved, RESOLVED_FLOOR)


def test_signature_match_allows_only_trailing_defaults():
    def port(a, b=1, device=None):
        pass

    def short(a, device=None):
        pass

    assert _matches("(a, b=1)", port)
    assert not _matches("(a, b=1)", short)
    assert not _matches("(a, b=2)", port)
    assert _params("(self, a)") == "(a)" and _params("(self)") == "()"

    def typed(x, dtype=torch.float32, act=torch.tanh):
        pass

    assert _matches("(x, dtype=<class 'jax.numpy.float32'>, act=<PjitFunction"
                    " of <function tanh at 0x...>>)", typed)
    assert not _matches("(x, dtype=<class 'jax.numpy.int32'>, act=<"
                        "PjitFunction of <function tanh at 0x...>>)", typed)
    assert not _matches("(x, dtype=<class 'jax.numpy.float32'>, act=<"
                        "PjitFunction of <function relu at 0x...>>)", typed)


# ---------------------------------------------------------------------------
# queue 3 repairs
# ---------------------------------------------------------------------------
def test_ops_star_exports_the_ported_op_modules():
    """F2: reference code's ``ops.<name>`` resolves for every ported op;
    the kernels stay a submodule."""
    for mod in (ops.activation, ops.loss, ops.math, ops.nn, ops.reduce,
                ops.selected_rows, ops.tensor_ops):
        for name in mod.__all__:
            assert getattr(ops, name) is getattr(mod, name), name
    assert ops.huber_loss is ops.loss.huber_loss
    assert ops.softmax_with_cross_entropy is \
        ops.loss.softmax_with_cross_entropy
    assert inspect.ismodule(ops.kernels)
    x = torch.tensor([[0.5, -2.0]])
    y = torch.tensor([[0.0, 0.0]])
    torch.testing.assert_close(ops.huber_loss(x, y, 1.0),
                               ops.loss.huber_loss(x, y, 1.0))


def test_layers_softmax_takes_the_layer_signature():
    """F1 (the static program's attrs against the JAX package are in
    tests/test_torch_static.py)."""
    x = torch.randn(2, 5, generator=torch.Generator().manual_seed(0))
    want = torch.softmax(x, dim=-1)
    torch.testing.assert_close(tpt.layers.softmax(x, False), want)
    torch.testing.assert_close(tpt.layers.softmax(input=x, use_cudnn=True),
                               want)
    torch.testing.assert_close(tpt.layers.softmax(x, axis=0),
                               torch.softmax(x, dim=0))


def _fc_program():
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup):
        x = tpt.data("x", [-1, 4], "float32")
        y = tpt.data("y", [-1, 1], "float32")
        pred = tpt.layers.fc(x, 1)
        loss = tpt.layers.mean(tpt.layers.square_error_cost(pred, y))
    return main, startup, pred, loss


def test_append_backward_takes_callbacks_and_refuses_checkpoints():
    """F3: ``callbacks`` is ignored as in the JAX package. F11: recompute
    ``checkpoints`` are taken as the JAX function takes them, recorded as
    ``"checkpoint": True`` in the autodiff op's attrs and nothing more (the
    documents and gradients against the JAX package are in
    tests/test_torch_static.py)."""
    from paddle_tpu_torch.static.backward import append_backward
    main, _, _, loss = _fc_program()
    with tpt.program_guard(main):
        pg = append_backward(loss, callbacks=[lambda *a: None],
                             checkpoints=None)
    assert [p.name for p, _ in pg] and main.global_block().ops[-1].type == \
        "autodiff"
    assert main.global_block().ops[-1].attrs["checkpoint"] is False
    main, _, _, loss = _fc_program()
    pg = append_backward(loss, checkpoints=[loss])
    assert main.global_block().ops[-1].attrs["checkpoint"] is True
    assert [p.name for p, _ in pg]


def test_the_f10_names_are_exported_where_the_reference_exports_them():
    """F10: the ported names the JAX package re-exports resolve at the same
    places, and a plain ``import paddle_tpu_torch`` binds ``inference``,
    ``distributed`` and ``monitor`` (a subprocess: this process has
    imported them by name already)."""
    import subprocess
    from paddle_tpu_torch import dataio, io, layers, static
    from paddle_tpu_torch.static import io as static_io
    for n in ("save_inference_model", "load_inference_model", "save_params",
              "load_params", "save_persistables", "load_persistables",
              "append_save_op", "append_load_op"):
        assert getattr(static, n) is getattr(static_io, n), n
    assert io.PyReader is dataio.PyReader
    for n in ("SelectedRows", "merge_selected_rows",
              "get_tensor_from_selected_rows", "lookup_sparse_table",
              "sparse_sgd_update", "split_selected_rows"):
        assert getattr(layers, n).__wrapped__ is getattr(ops, n), n
    sr = layers.SelectedRows(torch.tensor([2, 0, 2]), torch.ones(3, 2), 4)
    merged, valid = layers.merge_selected_rows(sr)
    assert merged.rows.tolist() == [0, 2, 0] and valid.tolist() == [
        True, True, False]
    assert tpt.Variable is static.Variable
    assert isinstance(tpt.Variable.program, property)
    assert tpt.enforce_eq is tpt.core.enforce.enforce_eq
    with pytest.raises(EnforceNotMet):
        tpt.enforce(False, "x")
    code = ("import paddle_tpu_torch as pt; "
            "print(pt.inference.__name__, pt.distributed.__name__, "
            "pt.monitor.__name__)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         cwd=os.path.join(os.path.dirname(__file__), ".."))
    assert out.stdout.split() == ["paddle_tpu_torch.inference",
                                  "paddle_tpu_torch.distributed",
                                  "paddle_tpu_torch.monitor"]


def test_apply_gradients_takes_param_meta():
    """F3: ``param_meta`` is accepted and ignored, as in the JAX package."""
    gen = torch.Generator().manual_seed(1)
    params = {"w": torch.randn(3, 2, generator=gen)}
    grads = {"w": torch.randn(3, 2, generator=gen)}
    runs = []
    for meta in (None, {"w": {"decay": True}}):
        opt = tpt.optimizer.Adam(learning_rate=0.1)
        p = {"w": params["w"].clone()}
        state = opt.init(p)
        p, state = opt.apply_gradients(p, grads, state, param_meta=meta)
        runs.append(p["w"])
    torch.testing.assert_close(runs[0], runs[1], atol=0, rtol=0)
    assert not torch.equal(runs[0], params["w"])


def test_serving_config_takes_hbm_limit_bytes():
    """F3: the default is accepted, and so is a limit now that the hot
    swap's memory-aware admission is ported (its refusal against the JAX
    package is in tests/test_torch_swap.py)."""
    from paddle_tpu_torch.serving import ServingConfig
    assert ServingConfig(hbm_limit_bytes=None).hbm_limit_bytes is None
    assert ServingConfig(hbm_limit_bytes=1 << 30).hbm_limit_bytes == 1 << 30


def test_export_aot_takes_platforms(tmp_path):
    """F3: ``platforms`` is accepted and ignored (the port writes no
    StableHLO export): the index entries are those of the default call."""
    from paddle_tpu_torch import inference
    main, startup, pred, _ = _fc_program()
    scope = tpt.Scope()
    exe = tpt.Executor(tpt.CPUPlace())
    exe.run(startup, scope=scope)
    buckets = [{"x": ((2, 4), "float32")}]
    keys = []
    for i, plat in enumerate((("cpu", "tpu"), ("cpu",))):
        d = str(tmp_path / f"m{i}")
        entries = inference.export_aot(d, main, ["x"], [pred.name], scope,
                                       buckets, platforms=plat)
        keys.append(sorted((e["sig"], e["program_hash"]) for e in entries))
    assert keys[0] == keys[1] and keys[0]


def test_optimize_program_takes_record_and_refuses_cost_probe():
    """``record`` publishes each pass application to the cost monitor
    (``program_pass_runs_total``; ``record=False`` publishes nothing) and a
    cost probe's per-pass deltas land in the report and the evidence
    table, as in the JAX package (opt_passes.py:709-780); a probe that
    raises stops probing, never the pipeline."""
    from paddle_tpu_torch.monitor.registry import REGISTRY
    from paddle_tpu_torch.static import opt_passes
    main, _, pred, _ = _fc_program()
    runs = REGISTRY.get("program_pass_runs_total")
    n0 = sum(runs.samples().values())
    a, _ = opt_passes.optimize_program(main, targets=(pred.name,),
                                       record=False)
    assert sum(runs.samples().values()) == n0
    b, rep = opt_passes.optimize_program(main, targets=(pred.name,))
    assert sum(runs.samples().values()) == n0 + len(rep.per_pass)
    assert [op.type for op in a.global_block().ops] == \
        [op.type for op in b.global_block().ops]
    costs = iter([{"flops": 10.0, "bytes": 5.0}, {"flops": 4.0, "bytes": 5.0}]
                 + [{"flops": 4.0, "bytes": 5.0}] * 10)
    _, rep = opt_passes.optimize_program(main, targets=(pred.name,),
                                         cost_probe=lambda p: next(costs))
    assert rep.per_pass[0]["flops_delta"] == -6.0
    assert all(r["flops_delta"] == 0.0 for r in rep.per_pass[1:])

    def broken(p):
        raise RuntimeError("probe")
    assert opt_passes.optimize_for_execution(main, [pred.name],
                                             cost_probe=broken) is not None


def test_block_takes_parent_idx():
    """F3: ``static.Block(parent_idx=)`` is kept, as in the JAX package."""
    prog = tpt.Program()
    assert tpt.static.Block(prog, 1, parent_idx=0).parent_idx == 0
    assert tpt.static.Block(prog).parent_idx == -1


def test_monitor_re_exports_its_names():
    """F5: ``paddle_tpu.monitor``'s re-exports of registry and trace."""
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.monitor import (  # noqa: F401
        REGISTRY, TRACER, Counter, Gauge, Histogram, Registry, TraceContext,
        Tracer, counter, gauge, histogram, registry, trace,
    )
    assert monitor.Counter is registry.Counter
    assert monitor.Tracer is trace.Tracer and monitor.REGISTRY is \
        registry.REGISTRY
    assert all(hasattr(monitor, n) for n in monitor.__all__)


def test_tracer_takes_the_reference_signatures(tmp_path):
    """F6: ``Tracer(capacity, sample_rate, ...)``, ``enable(dirname=None,
    **kwargs)`` and ``start_trace(..., current=False)``; the slow reservoir's
    knobs and the trace file writer are ported (their behaviour against the
    JAX package is in tests/test_torch_trace.py)."""
    from paddle_tpu_torch.monitor import trace
    t = trace.Tracer(1024)
    assert t.capacity == 1024 and t._ring.maxlen == 1024
    assert t.sample_rate == 0.05
    for kw in ({"slow_keep": 4}, {"slow_window_s": 5.0},
               {"exemplar_factor": 1.0}):
        (k, v), = kw.items()
        assert getattr(trace.Tracer(**kw), k) == v
    ctx = t.start_trace("step", current=True)
    assert t._tls.current is ctx
    other = t.start_trace("request")
    assert t._tls.current is ctx
    t.end_trace(other)
    assert t._tls.current is ctx
    t.end_trace(ctx)
    assert getattr(t._tls, "current", None) is None

    old = trace.TRACER
    old_writer = old._writer
    try:
        assert trace.enable(str(tmp_path)) is old and trace.is_enabled()
        assert old._writer.path == str(tmp_path / "rank0.trace.jsonl")
        new = trace.enable(capacity=16, sample_rate=1.0)
        assert trace.TRACER is new and new.capacity == 16
        ctx = trace.start_trace("step", current=True)
        assert new._tls.current is ctx
        trace.end_trace(ctx)
        assert new._writer is old._writer
    finally:
        trace.disable()
        old._writer = old_writer
        trace.TRACER = old


@pytest.mark.parametrize("model", ["bert", "resnet", "vgg", "se_resnext",
                                   "transformer"])
def test_make_train_step_takes_mesh_at_its_reference_position(model):
    """F7: ``make_train_step(cfg, opt, mesh=None, steps_per_call=1,
    device=None)``; a mesh that is not None raises naming item 9."""
    import importlib
    m = importlib.import_module(f"paddle_tpu_torch.models.{model}")
    cfg = {"bert": lambda: m.bert_tiny(dtype=torch.float32),
           "resnet": lambda: m.resnet_cifar10(depth=8, image_size=16),
           "vgg": lambda: m.vgg11(num_classes=10, image_size=32, fc_dim=64),
           "se_resnext": lambda: m.se_resnext_tiny(),
           "transformer": lambda: m.transformer_tiny()}[model]()
    params = list(inspect.signature(m.make_train_step).parameters)
    assert params[:3] == ["cfg", "optimizer", "mesh"]
    with pytest.raises(EnforceNotMet, match="queue 1 item 9"):
        m.make_train_step(cfg, tpt.optimizer.SGD(0.1), object(),
                          device="cpu")
    if model == "transformer":
        return
    # a call written for the reference binds steps_per_call positionally
    init_fn, step_fn = m.make_train_step(cfg, tpt.optimizer.SGD(0.1), None,
                                         2, device="cpu")
    params, state = init_fn(torch.Generator().manual_seed(0))
    if model == "bert":
        batch = m.synthetic_batch(cfg, 2, 16)
        step_fn(params, state, batch)
    else:
        images, labels = m.synthetic_batch(cfg, 2)
        step_fn(params, state, images, labels)
    assert int(state["step"]) == 2


def test_bert_forward_and_mlm_loss_take_mesh():
    """F7: ``bert.forward(..., mesh=None)`` and ``mlm_loss(..., mesh=None)``
    at the reference's positions."""
    from paddle_tpu_torch.models import bert
    for fn, name in ((bert.forward, "attention_mask"),
                     (bert.mlm_loss, "batch")):
        ps = list(inspect.signature(fn).parameters)
        assert ps[ps.index(name) + 1] == "mesh"
    cfg = bert.bert_tiny(dtype=torch.float32)
    params = bert.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    batch = bert.synthetic_batch(cfg, 2, 16)
    a = bert.mlm_loss(params, cfg, batch, None)
    torch.testing.assert_close(a, bert.mlm_loss(params, cfg, batch),
                               rtol=0, atol=0)
    with pytest.raises(EnforceNotMet, match="queue 1 item 9"):
        bert.mlm_loss(params, cfg, batch, mesh=object())
    with pytest.raises(EnforceNotMet, match="queue 1 item 9"):
        bert.forward(params, cfg, batch["input_ids"], mesh=object())
