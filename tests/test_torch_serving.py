"""The Fluid inference and serving path of the port (paddle_tpu_torch)
against the JAX package, on the CPU, at the two served models' own widths:

- the serving MLP of ``bench.py`` (``_freeze_serving_mlp``: x[256] -> fc 256
  relu -> fc 256 relu -> fc 10);
- the word2vec book model (vocabulary 2073, embedding 32 shared by four
  context words, fc 256 sigmoid, fc 2073 softmax), saved for inference with
  fetch = the softmax.

Model directories carry the models across: one written by either package's
``save_inference_model`` / ``export_aot(quantize=...)`` is loaded, verified
and served by the other. The JAX package's int8 Pallas body runs in interpret
mode (``interpret=True``) beside its stock reference; its serving path runs
its stock bodies, as on any CPU.

Tolerances (fp32 throughout). The int8 kernel's plain body against the JAX
reference and Pallas bodies: fp32 sums of K products in another order, and
the JAX Pallas body dequantizes in its tile: within 1e-5 of the output's
largest magnitude (observed ~1e-6). Served outputs, the port against the
JAX package from one directory: the same fp32 arithmetic in another
summation order: within 1e-5 absolute (outputs of order 1 for the MLP, the
softmax's probabilities for word2vec). Quantized arrays and scale tables:
bit for bit. Fingerprints, model versions' content hashes and resident
bytes: equal.
"""

import json
import os
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu import inference as jinf
from paddle_tpu.framework import unique_name as junique
from paddle_tpu.monitor.registry import REGISTRY as JREGISTRY
from paddle_tpu.ops.pallas import matmul as jmm
from paddle_tpu.serving import InferenceServer as JServer
from paddle_tpu.serving import ServingConfig as JConfig
from paddle_tpu.serving import scheduler as jsched
from paddle_tpu.static import opt_passes as jpasses
from paddle_tpu.static import serialize as jser

import paddle_tpu_torch as tpt
from paddle_tpu_torch import inference as tinf
from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.monitor import trace as ttrace
from paddle_tpu_torch.monitor.registry import REGISTRY as TREGISTRY
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.serving import InferenceServer as TServer
from paddle_tpu_torch.serving import ServingConfig as TConfig
from paddle_tpu_torch.serving import scheduler as tsched
from paddle_tpu_torch.static import opt_passes as tpasses
from paddle_tpu_torch.static import serialize as tser

TOL = 1e-5
CPU = torch.device("cpu")
V, E, H = 2073, 32, 256
W2V_FEEDS = [f"w{i}" for i in range(4)]


def _build_mlp(pt, unique_name):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        x = pt.data("x", [256], "float32")
        h = pt.layers.fc(x, 256, act="relu")
        h = pt.layers.fc(h, 256, act="relu")
        out = pt.layers.fc(h, 10)
    return main, startup, out


def _build_w2v(pt, unique_name):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        words = [pt.data(n, [1], "int64") for n in W2V_FEEDS]
        nxt = pt.data("next", [1], "int64")
        embs = [pt.layers.embedding(w, size=[V, E], param_attr="shared_w")
                for w in words]
        hidden = pt.layers.fc(pt.layers.concat(embs, axis=1), H,
                              act="sigmoid")
        pred = pt.layers.fc(hidden, V, act="softmax")
        loss = pt.layers.mean(pt.layers.cross_entropy(pred, nxt))
        pt.optimizer.SGDOptimizer(learning_rate=0.001).minimize(loss)
    return main, startup, pred


_MODELS = {"mlp": (_build_mlp, ["x"], [{"x": ((1, 256), "float32")}]),
           "w2v": (_build_w2v, W2V_FEEDS,
                   [{n: ((1, 1), "int64") for n in W2V_FEEDS}])}


def _fixture(model, rows=16, seed=0):
    rng = np.random.RandomState(seed)
    if model == "mlp":
        return {"x": rng.rand(rows, 256).astype(np.float32)}
    return {n: rng.randint(0, V, (rows, 1)).astype(np.int64)
            for n in W2V_FEEDS}


def _jax_export(root, model):
    """The JAX package's directories of one model with one set of weights:
    fp32, int8 and bf16 (``save_inference_model``, then ``export_aot`` of
    the saved program). Returns ({mode: dir}, {param: numpy})."""
    build, feeds, buckets = _MODELS[model]
    main, startup, out = build(jpt, junique)
    scope = jpt.static.Scope()
    dirs = {}
    with jpt.static.scope_guard(scope):
        exe = jpt.Executor()
        exe.run(startup)
        for mode in ("fp32", "int8", "bf16"):
            d = dirs[mode] = os.path.join(root, f"jax_{model}_{mode}")
            jpt.io.save_inference_model(d, feeds, [out], exe,
                                        main_program=main)
            if mode != "fp32":
                prog, _, fetches = jpt.io.load_inference_model(
                    d, exe, scope=jpt.static.Scope())
                jinf.export_aot(d, prog, feeds, fetches, scope, buckets,
                                quantize=mode)
        params = {n: np.asarray(scope.find_var(n))
                  for n, v in main.global_block().vars.items()
                  if v.persistable and n != "@opt@SGDOptimizer@step"}
    return dirs, params


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("serving"))
    return {m: _jax_export(root, m) for m in _MODELS} | {"root": root}


def _serve(server_cls, config, d, feeds, chunk=4):
    """The fixture through a server in requests of ``chunk`` rows; returns
    (outputs, resident param bytes, model version, quant mode loaded)."""
    with server_cls(d, config) as srv:
        rows = len(next(iter(feeds.values())))
        outs = np.concatenate([
            np.asarray(srv.infer({n: a[i:i + chunk]
                                  for n, a in feeds.items()},
                                 timeout=60)[0])
            for i in range(0, rows, chunk)])
        return (outs, srv.pool.resident_param_bytes(), srv.model_version,
                srv._bundle.quantized)


def _jax_serve(d, feeds):
    return _serve(JServer, JConfig(max_batch=4), d, feeds)


def _port_serve(d, feeds):
    return _serve(TServer, TConfig(max_batch=4, devices=[CPU]), d, feeds)


def _load_both(d):
    with open(os.path.join(d, "__model__")) as f:
        text = f.read()
    return tser.loads_program(text)[0], jser.loads_program(text)[0]


# ---------------------------------------------------------------------------
# 1. documents
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("model", list(_MODELS))
def test_documents_load_across_packages(exports, model):
    dirs, _ = exports[model]
    tprog, jprog = _load_both(dirs["int8"])
    tdict, jdict = tser.program_to_dict(tprog), jser.program_to_dict(jprog)
    assert tdict["ops"] == jdict["ops"] and tdict["vars"] == jdict["vars"]
    assert tdict == jdict
    fp = tser.program_fingerprint(tprog)
    assert fp == jser.program_fingerprint(jprog)
    with open(os.path.join(dirs["int8"], "__aot__", "index.json")) as f:
        assert {e["program_hash"] for e in json.load(f)} == {fp[:16]}
    # the JAX initializers come back as the port's, with their state
    init = tprog.global_block().vars["fc_w"].initializer
    assert type(init) is tpt.initializer.XavierInitializer
    assert (init.uniform, init.fan_in, init.seed) == (True, None, 0)
    # and the port's document loads back in the JAX package
    back, _ = jser.loads_program(tser.dumps_program(tprog))
    assert jser.program_fingerprint(back) == fp


@pytest.mark.parametrize("opt", [
    lambda pt: pt.optimizer.SGDOptimizer(learning_rate=0.001),
    lambda pt: pt.optimizer.MomentumOptimizer(0.001, momentum=0.9),
    lambda pt: pt.optimizer.AdamOptimizer(learning_rate=0.001)],
    ids=["sgd", "momentum", "adam"])
def test_port_programs_write_the_jax_documents(opt):
    """The programs the port builds for a script, training (with its
    optimizer's ops and state) and saved for inference, are the documents
    the JAX package writes for the same script."""
    from paddle_tpu.static import io as jio
    from paddle_tpu_torch.static import io as tio

    def build(pt, unique_name):
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup), unique_name.guard():
            words = [pt.data(n, [1], "int64") for n in W2V_FEEDS]
            nxt = pt.data("next", [1], "int64")
            embs = [pt.layers.embedding(w, size=[V, E],
                                        param_attr="shared_w")
                    for w in words]
            hidden = pt.layers.fc(pt.layers.concat(embs, axis=1), H,
                                  act="sigmoid")
            pred = pt.layers.fc(hidden, V, act="softmax")
            loss = pt.layers.mean(pt.layers.cross_entropy(pred, nxt))
            opt(pt).minimize(loss)
        return main, startup, pred

    tprog, tstart, tout = build(tpt, tpt.unique_name)
    jprog, jstart, jout = build(jpt, junique)
    for t, j in ((tprog, jprog), (tstart, jstart)):
        assert tser.program_to_dict(t) == jser.program_to_dict(j)
    t = tio._prune(tprog.clone(for_test=True), W2V_FEEDS, [tout.name])
    j = jio._prune(jprog.clone(for_test=True), W2V_FEEDS, [jout.name])
    assert tser.program_fingerprint(t) == jser.program_fingerprint(j)


def test_documents_refuse_what_the_port_cannot_build(exports):
    # (a class the port does not have yet: the mesh config, queue 1 item 9;
    # WeightNormParamAttr, item 7d, decodes since the eager surface came)
    node = {"__obj__": "paddle_tpu.parallel.mesh:MeshConfig", "state": {}}
    with pytest.raises(tser.SerializationError,
                       match="MeshConfig.*queue 1: items 9 and 10"):
        tser.decode_value(node)
    wn = tser.decode_value({"__obj__": "paddle_tpu.framework:"
                                       "WeightNormParamAttr",
                            "state": {"dim": 1}})
    assert type(wn) is tpt.WeightNormParamAttr and wn.dim == 1
    for path in ("os:system", "paddle_tpu_torch.initializer:Constant",
                 "paddle_tpu.nosuchmodule:Thing"):
        with pytest.raises(tser.SerializationError):
            tser.decode_value({"__obj__": path, "state": {}})
    assert tser.decode_value({"__dtype__": "bfloat16"}) is torch.bfloat16
    with pytest.raises(tser.SerializationError, match="callable"):
        tser.encode_value(lambda: 0)


# ---------------------------------------------------------------------------
# 2. weight-only PTQ
# ---------------------------------------------------------------------------
def _optimized(d, fetch_of):
    tprog, jprog = _load_both(d)
    return (tpasses.optimize_inference(tprog, fetch_of(tprog)),
            jpasses.optimize_inference(jprog, fetch_of(jprog)))


def _ops(program):
    return [(op.type, op.inputs, op.outputs,
             {k: v for k, v in op.attrs.items() if k != "_rng_idx"})
            for op in program.global_block().ops]


@pytest.mark.parametrize("mode", ["int8", "bf16"])
@pytest.mark.parametrize("model", list(_MODELS))
def test_weight_quant_matches_jax(exports, model, mode):
    dirs, params = exports[model]
    with open(os.path.join(dirs["fp32"], "__model__")) as f:
        fetches = json.load(f)["fetch_names"]
    tprog, jprog = _optimized(dirs["fp32"], lambda p: fetches)
    assert _ops(tprog) == _ops(jprog)
    tvals = {n: torch.tensor(a) for n, a in params.items()}
    plan = tpasses.plan_weight_quant(tprog, tvals, mode)
    assert plan == jpasses.plan_weight_quant(jprog, params, mode)
    assert plan == (["fc_w", "fc_w_1", "fc_w_2"] if model == "mlp"
                    else ["fc_w", "fc_w_1"])
    tq = tpasses.quantize_weight_values(tvals, plan, mode)
    jq = jpasses.quantize_weight_values(params, plan, mode)
    assert sorted(tq) == sorted(jq)
    for n, want in jq.items():
        got = tq[n]
        if mode == "bf16":       # the 16-bit lanes
            got = got.view(torch.int16).numpy()
            want = np.asarray(want).view(np.int16)
        else:
            got = got.numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want), n
    tq_prog = tpasses.apply_weight_quant(tprog, plan, mode)
    jq_prog = jpasses.apply_weight_quant(jprog, plan, mode)
    assert _ops(tq_prog) == _ops(jq_prog)
    assert sum(op.attrs.get("quant") == mode
               for op in tq_prog.global_block().ops) == len(plan)
    # the model version's content hash over the same program and values
    names = sorted(n for n, v in tq_prog.global_block().vars.items()
                   if v.persistable)
    h = tinf._program_hash(tprog)
    assert h == jinf._program_hash(jprog)
    tv = [tq.get(n, tvals.get(n)) for n in names]
    jv = [np.asarray(jq.get(n, params.get(n))) for n in names]
    assert tinf._model_version_of(h, names, tv)[:12] == \
        jinf._model_version_of(h, names, jv)[:12]


# ---------------------------------------------------------------------------
# 3. the int8 kernel's plain body
# ---------------------------------------------------------------------------
_INT8_SHAPES = [(m, k, n) for m in (1, 8)
                for k, n in ((256, 256), (256, 10), (4 * E, H), (H, V))] \
    + [(33, 70, 130)]


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("act", [None, "relu", "sigmoid", "tanh", "gelu"])
def test_fused_matmul_int8_matches_jax(act, with_bias):
    rng = np.random.RandomState(7)
    for m, k, n in _INT8_SHAPES:
        x = rng.randn(m, k).astype(np.float32)
        w = rng.randint(-128, 128, (k, n)).astype(np.int8)
        scale = (rng.rand(n) + 0.05).astype(np.float32)
        b = rng.randn(n).astype(np.float32) if with_bias else None
        targs = [torch.from_numpy(a) if a is not None else None
                 for a in (x, w, scale, b)]
        got = K.fused_matmul_int8(*targs, act).numpy()
        ref = np.asarray(jmm.fused_matmul_int8_reference(x, w, scale, b,
                                                         act))
        assert got.dtype == np.float32 and got.shape == (m, n)
        tol = TOL * np.abs(ref).max()
        np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
        if m == 8 or (m, k, n) == (33, 70, 130):
            pal = np.asarray(jmm.fused_matmul_int8_pallas(
                x, w, scale, b, act, interpret=True))
            np.testing.assert_allclose(got, pal, rtol=0, atol=tol)


def test_fused_matmul_op_dispatch_matches_jax():
    """The static op's quant branches: the kernels' path and the
    composition outside their contract, against the JAX package's op."""
    from paddle_tpu.static.program import OP_REGISTRY as JOPS
    from paddle_tpu_torch.static.program import OP_REGISTRY as TOPS
    rng = np.random.RandomState(8)
    x = rng.randn(6, 24).astype(np.float32)
    wf = rng.randn(24, 5).astype(np.float32)
    q = tpasses.quantize_weight_values({"w": wf}, ["w"], "int8")
    w8, s8 = q["w"].numpy(), q["w@quant_scale"].numpy()
    b = rng.randn(5).astype(np.float32)
    cases = [
        ("int8", [x, w8, s8, b], {"mm_type": "mul", "has_bias": True}),
        ("int8", [x, w8, s8], {"mm_type": "matmul", "has_bias": False,
                               "mm_attrs": {"alpha": 2.0}}),   # composed
        ("bf16", [x, wf, b], {"mm_type": "mul", "has_bias": True}),
    ]
    for quant, xs, attrs in cases:
        attrs = dict(attrs, quant=quant, act="tanh")
        jxs = [jnp.asarray(a) if quant != "bf16" or i != 1
               else jnp.asarray(a, jnp.bfloat16) for i, a in enumerate(xs)]
        txs = [torch.from_numpy(a) if quant != "bf16" or i != 1
               else torch.from_numpy(a).to(torch.bfloat16)
               for i, a in enumerate(xs)]
        want = np.asarray(JOPS["fused_matmul"]({"X": jxs}, attrs)["Out"][0])
        got = TOPS["fused_matmul"]({"X": txs}, attrs)["Out"][0]
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


# ---------------------------------------------------------------------------
# 4.-5. serving both ways, the Predictor
# ---------------------------------------------------------------------------
_PARAM_BYTES = {("mlp", "fp32"): 536_616, ("mlp", "int8"): 137_808}


@pytest.mark.parametrize("model,mode", [
    ("mlp", "fp32"), ("mlp", "int8"), ("mlp", "bf16"), ("w2v", "int8")])
def test_port_serves_jax_directories(exports, model, mode):
    dirs, _ = exports[model]
    feeds = _fixture(model)
    want, jbytes, jver, jq = _jax_serve(dirs[mode], feeds)
    got, tbytes, tver, tq = _port_serve(dirs[mode], feeds)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert tbytes == jbytes == _PARAM_BYTES.get((model, mode), jbytes)
    assert tver == jver and (tver is None) == (mode == "fp32")
    assert tq == jq == (None if mode == "fp32" else mode)


@pytest.mark.parametrize("model", list(_MODELS))
def test_jax_serves_port_directories(exports, model):
    """A directory written by the port's save_inference_model and
    export_aot(quantize="int8") serves in the JAX package (its retrace
    path: the port writes no executable) with the port's outputs."""
    _, params = exports[model]
    build, feeds, buckets = _MODELS[model]
    main, startup, out = build(tpt, tpt.unique_name)
    scope = tpt.Scope.from_numpy(
        dict(params, **({"@opt@SGDOptimizer@step": np.asarray(0, np.int32)}
                        if model == "w2v" else {})), CPU, startup)
    d = os.path.join(exports["root"], f"port_{model}_int8")
    with tpt.scope_guard(scope):
        exe = tpt.Executor(tpt.CPUPlace())
        tpt.io.save_inference_model(d, feeds, [out], exe, main_program=main)
        prog, _, fetches = tpt.io.load_inference_model(d, exe,
                                                       scope=tpt.Scope())
        entries = tinf.export_aot(d, prog, feeds, fetches, scope, buckets,
                                  quantize="int8")
    assert all("xla" not in e and "shlo" not in e and "torch_version" in e
               for e in entries)
    fixture = _fixture(model, seed=1)
    got, tbytes, tver, _ = _port_serve(d, fixture)
    want, jbytes, jver, jq = _jax_serve(d, fixture)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert tbytes == jbytes and tver == jver == entries[0]["model_version"]
    assert jq == "int8"
    # the JAX Predictor takes its retrace path over the port's index
    jpred = jinf.create_predictor(jinf.Config(d))
    pred = tinf.create_predictor(_cpu_config(d))
    np.testing.assert_allclose(pred.run(fixture)[0], jpred.run(fixture)[0],
                               rtol=0, atol=TOL)


def test_save_inference_model_writes_the_aot_index(tmp_path):
    """``aot_shapes`` routes to export_aot: an fp32 index entry per bucket,
    no file to verify, and the Predictor serves the directory."""
    main, startup, out = _build_mlp(tpt, tpt.unique_name)
    scope = tpt.Scope()
    exe = tpt.Executor(tpt.CPUPlace())
    exe.run(startup, scope=scope)
    d = str(tmp_path / "mlp")
    with tpt.scope_guard(scope):
        tpt.io.save_inference_model(
            d, ["x"], [out], exe, main_program=main,
            aot_shapes=[{"x": ((n, 256), "float32")} for n in (1, 4)])
    with open(os.path.join(d, "__aot__", "index.json")) as f:
        entries = json.load(f)
    assert [e["sig"][0][1] for e in entries] == [[1, 256], [4, 256]]
    assert all("quant" not in e and not e["integrity"] for e in entries)
    res = tinf.verify_aot_dir(d)
    assert res == 0 and res.model_version == entries[0]["model_version"]
    assert tinf.read_aot_version(d) == res.model_version
    assert tinf.load_quantized_params(d) is None
    x = _fixture("mlp", rows=3)
    want = exe.run(main, feed=x, fetch_list=[out], scope=scope)[0]
    got = tinf.create_predictor(_cpu_config(d)).run(x)[0]
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def _cpu_config(d):
    cfg = tinf.Config(d)
    cfg.disable_gpu()
    return cfg


@pytest.mark.parametrize("model", list(_MODELS))
def test_predictor_matches_jax(exports, model):
    dirs, _ = exports[model]
    feeds = _fixture(model, rows=5, seed=2)
    jpred = jinf.create_predictor(jinf.Config(dirs["int8"]))
    pred = tinf.create_predictor(_cpu_config(dirs["int8"]))
    assert pred.get_input_names() == jpred.get_input_names()
    assert pred.get_output_names() == jpred.get_output_names()
    want = jpred.run(feeds)
    got = pred.run(feeds)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=TOL)
    # the zero-copy handles of a clone
    c = pred.clone()
    for n in c.get_input_names():
        c.get_input_handle(n).copy_from_cpu(feeds[n])
    c.run()
    out = c.get_output_handle(c.get_output_names()[0]).copy_to_cpu()
    np.testing.assert_array_equal(out, got[0])
    assert pred._outputs is not c._outputs


def test_default_device_is_the_card(exports, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = exports["mlp"][0]["int8"]
    with pytest.raises(tpt.NoCudaDeviceError):
        tinf.create_predictor(tinf.Config(d))
    with pytest.raises(tpt.NoCudaDeviceError):
        TServer(d, TConfig(max_batch=2))


# ---------------------------------------------------------------------------
# 6. integrity
# ---------------------------------------------------------------------------
def test_flipped_scale_byte_fails_integrity(exports, tmp_path):
    import shutil
    src = exports["mlp"][0]["int8"]
    d = str(tmp_path / "mlp_int8")
    shutil.copytree(src, d)
    assert tinf.verify_aot_dir(d) == 3         # .xla, .shlo, the sidecar
    (qfile,) = [f for f in os.listdir(os.path.join(d, "__aot__"))
                if f.startswith("quant.")]
    path = os.path.join(d, "__aot__", qfile)
    with np.load(path) as z:
        scale = z["fc_w@quant_scale"].tobytes()
    with open(path, "rb") as f:
        blob = bytearray(f.read())
    at = blob.find(scale)
    assert at > 0
    blob[at + 5] ^= 0x40
    with open(path, "wb") as f:
        f.write(bytes(blob))
    for fn in (lambda: tinf.verify_aot_dir(d),
               lambda: tinf.load_quantized_params(d),
               lambda: TServer(d, TConfig(max_batch=2, devices=[CPU])),
               lambda: tinf.create_predictor(_cpu_config(d))):
        with pytest.raises(tinf.AOTIntegrityError, match=qfile):
            fn()


# ---------------------------------------------------------------------------
# 7. the scheduler and failures, against both packages
# ---------------------------------------------------------------------------
_PKGS = {"jax": (jsched, JREGISTRY), "port": (tsched, TREGISTRY)}


class _FakeDispatch:
    """Completes each formed batch inline with out = x * 2, after an
    optional gate, or raises ``fail_with``."""

    def __init__(self, gate=None, fail_with=None):
        self.batches = []
        self.gate = gate
        self.fail_with = fail_with

    def __call__(self, mb):
        self.batches.append(mb)
        if self.gate is not None:
            self.gate.wait()
        if self.fail_with is not None:
            raise self.fail_with
        mb.complete([mb.feeds["x"] * 2.0])


def _sched(sch, dispatch, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_wait_ms", 50.0)
    kw.setdefault("max_queue", 64)
    return sch.MicroBatchScheduler(dispatch, ("x",), **kw).start()


def _row(v, rows=1):
    return {"x": np.full((rows, 2), float(v), np.float32)}


def _count(reg, name, **labels):
    m = reg.get(name)
    return m.value(**labels) if m else 0.0


@pytest.mark.parametrize("pkg", list(_PKGS))
def test_scheduler_ladder_and_padding(pkg):
    sch, reg = _PKGS[pkg]
    assert sch.bucket_ladder(8) == (1, 2, 4, 8)
    assert [sch.pick_bucket(r, (1, 2, 4, 8)) for r in (1, 3, 5)] == [1, 4, 8]
    with pytest.raises(Exception, match="power of two"):
        sch.bucket_ladder(6)
    waste0 = _count(reg, "serving_padded_waste_total")
    disp = _FakeDispatch()
    s = _sched(sch, disp, max_wait_ms=250.0)
    pends = [s.submit(_row(i + 1)) for i in range(3)]
    outs = [p.result(timeout=10) for p in pends]
    s.close()
    (mb,) = disp.batches
    assert (mb.bucket, mb.rows, mb.feeds["x"].shape) == (4, 3, (4, 2))
    np.testing.assert_array_equal(mb.feeds["x"][3], 0.0)
    for i, out in enumerate(outs):
        np.testing.assert_allclose(out[0], np.full((1, 2), 2.0 * (i + 1)))
    assert _count(reg, "serving_padded_waste_total") - waste0 == 1


@pytest.mark.parametrize("pkg", list(_PKGS))
def test_scheduler_queue_full_is_typed(pkg):
    sch, reg = _PKGS[pkg]
    rej0 = _count(reg, "serving_requests_total", outcome="rejected")
    gate = threading.Event()
    disp = _FakeDispatch(gate=gate)
    s = _sched(sch, disp, max_wait_ms=0.0, max_queue=3)
    first = s.submit(_row(0))
    deadline = time.time() + 5
    while not disp.batches and time.time() < deadline:
        time.sleep(0.001)
    admitted = [s.submit(_row(i + 1)) for i in range(3)]
    with pytest.raises(sch.QueueFullError, match="max_queue=3"):
        s.submit(_row(99))
    assert _count(reg, "serving_requests_total",
                  outcome="rejected") - rej0 == 1
    gate.set()
    assert s.close(timeout=10)
    for p in [first] + admitted:
        p.result(timeout=0)


@pytest.mark.parametrize("pkg", list(_PKGS))
def test_scheduler_deadline_expiry(pkg):
    sch, reg = _PKGS[pkg]
    dl0 = _count(reg, "serving_requests_total", outcome="deadline")
    gate = threading.Event()
    disp = _FakeDispatch(gate=gate)
    s = _sched(sch, disp, max_wait_ms=0.0)
    with pytest.raises(sch.DeadlineExceededError, match="admission"):
        s.submit(_row(1), deadline_ms=0)
    blocker = s.submit(_row(1))             # holds the dispatch thread
    late = s.submit(_row(2), deadline_ms=20)
    time.sleep(0.1)
    gate.set()
    blocker.result(timeout=10)
    with pytest.raises(sch.DeadlineExceededError, match="deadline 20ms"):
        late.result(timeout=10)
    s.close()
    assert _count(reg, "serving_requests_total",
                  outcome="deadline") - dl0 == 2


@pytest.mark.parametrize("pkg", list(_PKGS))
def test_scheduler_drains_on_close(pkg):
    sch, reg = _PKGS[pkg]
    ok0 = _count(reg, "serving_requests_total", outcome="ok")
    s = _sched(sch, _FakeDispatch(), max_wait_ms=0.0)
    pends = [s.submit(_row(i)) for i in range(12)]
    assert s.close(timeout=10)
    for i, p in enumerate(pends):
        np.testing.assert_allclose(p.result(timeout=0)[0],
                                   np.full((1, 2), 2.0 * i))
    assert _count(reg, "serving_requests_total", outcome="ok") - ok0 == 12
    with pytest.raises(sch.ServerClosedError):
        s.submit(_row(1))


@pytest.mark.parametrize("pkg", list(_PKGS))
def test_scheduler_failing_dispatch_delivers_typed_error(pkg):
    sch, reg = _PKGS[pkg]
    err0 = _count(reg, "serving_requests_total", outcome="error")
    s = _sched(sch, _FakeDispatch(fail_with=RuntimeError("replica down")),
               max_wait_ms=0.0)
    p = s.submit(_row(1))
    with pytest.raises(RuntimeError, match="replica down"):
        p.result(timeout=10)
    s.close()
    assert _count(reg, "serving_requests_total",
                  outcome="error") - err0 == 1


def test_server_failures_are_typed(exports):
    """A poisoned batch fails its riders and the replica keeps serving; a
    wedged replica is quarantined, its riders fail with ReplicaLostError,
    and the slot respawns; a drain refuses new work with the retryable
    error and close drains what was accepted."""
    from paddle_tpu_torch.serving import (
        ReplicaLostError, ServerDrainingError,
    )
    d = exports["mlp"][0]["int8"]
    x = _fixture("mlp", rows=2)
    srv = TServer(d, TConfig(max_batch=2, max_wait_ms=0.0, devices=[CPU],
                             replica_stall_ms=200.0,
                             respawn_backoff_ms=10.0))
    try:
        want = srv.infer(x, timeout=30)[0]
        replica = srv.pool.replicas[0]
        run = replica.run_batch
        state = {"n": 0}

        def flaky(bucket, feeds):
            state["n"] += 1
            if state["n"] == 1:
                raise ValueError("poisoned batch")
            if state["n"] == 2:
                time.sleep(1.0)              # wedged past the stall limit
            return run(bucket, feeds)

        replica.run_batch = flaky
        with pytest.raises(ValueError, match="poisoned batch"):
            srv.infer(x, timeout=30)
        with pytest.raises(ReplicaLostError, match="wedged"):
            srv.infer(x, timeout=30)
        deadline = time.time() + 10
        while srv.pool.replicas[0] is replica and time.time() < deadline:
            time.sleep(0.01)
        assert srv.pool.replicas[0] is not replica      # respawned
        np.testing.assert_array_equal(srv.infer(x, timeout=30)[0], want)
        pend = srv.submit(x)
        assert srv.begin_drain() and srv.draining
        with pytest.raises(ServerDrainingError):
            srv.submit(x)
        np.testing.assert_array_equal(pend.result(timeout=30)[0], want)
    finally:
        assert srv.close(timeout=30)


def test_server_traces_requests_when_armed(exports):
    d = exports["mlp"][0]["fp32"]
    ttrace.enable(sample_rate=1.0)
    try:
        with TServer(d, TConfig(max_batch=2, devices=[CPU])) as srv:
            pend = srv.submit(_fixture("mlp", rows=1))
            pend.result(timeout=30)
        names = {s["name"] for s in ttrace.spans(pend.trace_id)}
        assert {"serving/request", "serving/queue_wait",
                "serving/batch_form", "serving/execute",
                "serving/deliver"} <= names
    finally:
        ttrace.disable()
    assert not ttrace.is_enabled()


# ---------------------------------------------------------------------------
# 8. not ported yet
# ---------------------------------------------------------------------------
def test_what_is_not_ported_raises(exports):
    """The hot swap, ``watch_dir`` and the HBM-pressure shed input are
    ported (tests/test_torch_swap.py holds them against the JAX package):
    they no longer raise. The save/load ops and ``save_vars``/``load_vars``
    are ported too (tests/test_torch_checkpoint.py holds their files
    against the JAX package's). The memory monitor's segment functions
    are ported: nothing is measured on the CPU, so nothing is recorded."""
    from paddle_tpu_torch.monitor import memory as tmem
    d = exports["mlp"][0]["fp32"]
    with TServer(d, TConfig(max_batch=2, devices=[CPU], shed_mode="adaptive",
                            default_deadline_ms=50.0,
                            shed_hbm_frac=0.9)) as srv:
        assert srv.scheduler._shed.hbm_high_frac == 0.9
        ctl = srv.watch_dir(poll_ms=50.0)
        assert ctl.stop_watch()
        # the served directory's own version: the gate passes, the swap
        # commits (nothing else has changed)
        assert srv.swap(d, watchdog_ms=0)["outcome"] == "ok"
    main, _, out = _build_mlp(tpt, tpt.unique_name)
    exe = tpt.Executor(tpt.CPUPlace())
    # a var not in the scope is refused by name; the save_combine and
    # load_combine host ops are appended
    with pytest.raises(EnforceNotMet, match="not in scope"):
        tpt.io.save_vars(exe, d, vars=["no_such_var"])
    op = tpt.static.io.append_save_op(main, [out], "f")
    assert op.type == "save_combine" and op.attrs["var_names"] == [out.name]
    op = tpt.static.io.append_load_op(main, [out], "f")
    assert op.type == "load_combine" and op.attrs["var_names"] == [out.name]
    before = (tmem.memory_segments(), tmem.peak_bytes_per_step())
    assert tmem.analyze_compiled(None) is None
    tmem.record_segment_memory(0, 0, tmem.analyze_compiled(None))
    tmem.record_segment_memory(0, 0, {})
    assert (tmem.memory_segments(), tmem.peak_bytes_per_step()) == before


# ---------------------------------------------------------------------------
# 7. an op that draws in a frozen program (F12)
def test_dropout_program_exports_and_serves(tmp_path):
    """F12: an fc -> dropout(0.5) -> fc model saved with
    ``save_inference_model`` (its dropout frozen for inference, still an op
    that draws): ``export_aot`` and the server take it, where the port
    refused any ``_needs_rng`` op, and they agree with the port's and the
    JAX package's ``Predictor`` on the same directory."""
    d = str(tmp_path / "drop")
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup), tpt.unique_name.guard():
        x = tpt.data("x", [8], "float32")
        h = tpt.layers.dropout(tpt.layers.fc(x, 16, act="relu"), 0.5)
        out = tpt.layers.fc(h, 4)
    scope, exe = tpt.Scope(), tpt.Executor(tpt.CPUPlace())
    exe.run(startup, scope=scope)
    with tpt.scope_guard(scope):
        tpt.io.save_inference_model(d, ["x"], [out], exe, main_program=main)
    prog, feeds, fetches = tpt.io.load_inference_model(d, exe,
                                                       scope=tpt.Scope())
    drop = [op for op in prog.global_block().ops if op.type == "dropout"]
    assert len(drop) == 1 and drop[0].attrs["_needs_rng"]
    xb = np.random.RandomState(3).rand(3, 8).astype(np.float32)
    entries = tinf.export_aot(d, prog, feeds, fetches, scope,
                              [{"x": ((3, 8), "float32")}])
    assert entries
    want = tinf.create_predictor(_cpu_config(d)).run({"x": xb})[0]
    with TServer(d, TConfig(max_batch=4, devices=[CPU])) as srv:
        served = np.asarray(srv.infer({"x": xb}, timeout=60)[0])
    np.testing.assert_array_equal(served, want)
    jwant = jinf.create_predictor(jinf.Config(d)).run({"x": xb})[0]
    np.testing.assert_allclose(want, np.asarray(jwant), rtol=0, atol=TOL)


def test_pure_fn_draws_the_executors_first_run_mask():
    """F12: in the AOT function a dropout that trains draws, on every call,
    the mask the Executor draws at its first run of the program (the JAX
    function's step-0 keys): calls agree with each other and with that run,
    and the Executor's second run draws another."""
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup), tpt.unique_name.guard():
        x = tpt.data("x", [64], "float32")
        out = tpt.layers.dropout(x, 0.5)
    xb = np.ones((4, 64), np.float32)
    exe, scope = tpt.Executor(tpt.CPUPlace()), tpt.Scope()
    exe.run(startup, scope=scope)
    runs = [exe.run(main, feed={"x": xb}, fetch_list=[out], scope=scope)[0]
            for _ in range(2)]
    fn, names = tinf._build_pure_fn(main, ["x"], [out.name])
    calls = [fn(tuple(scope.find_var(n) for n in names),
                (torch.from_numpy(xb),))[0].numpy() for _ in range(2)]
    np.testing.assert_array_equal(calls[0], calls[1])
    np.testing.assert_array_equal(calls[0], runs[0])
    assert not np.array_equal(runs[0], runs[1])
    assert 0.3 < (calls[0] == 0).mean() < 0.7
