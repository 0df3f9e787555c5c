"""The HTTP front door of the port (``paddle_tpu_torch/serving/frontdoor.py``)
against the JAX package's, on the CPU.

One request sequence goes through each package's ``HttpFrontDoor`` over
loopback, with the package's own ``WireClient``: ok (the serving MLP of
``tests/test_torch_serving.py``, a JAX-written directory, served by each
package's ``InferenceServer`` at ``max_batch`` 2), bad JSON 400, over the body
bound 413, a stalled body 408 (the socket timeout), an exhausted
``X-Deadline-Ms`` 504 (refused at admission), queue full 429, overloaded 429,
a tenant over its quota 429, draining 503, and a client that hangs up while
its result is awaited. Queue full, overloaded, the held tenant and the
disconnect run against a small recording server of each package's own types
(the JAX package's front-door tests use the same stand-in): the front door's
mapping of a typed error is what they hold. The status codes, the
``Retry-After`` headers, the ``serving_http_requests_total`` outcome deltas
and the tenant counters must be equal; the served outputs within 1e-5 of the
JAX package's, relative to their largest magnitude.
"""

import socket
import threading
import time
import types

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu import inference as jinf
from paddle_tpu.framework import unique_name as junique
from paddle_tpu.monitor.registry import REGISTRY as JREGISTRY
from paddle_tpu.serving import frontdoor as jfd
from paddle_tpu.serving import resilience as jres
from paddle_tpu.serving import scheduler as jsch
from paddle_tpu.serving import InferenceServer as JServer
from paddle_tpu.serving import ServingConfig as JConfig
from paddle_tpu.static.program import static_mode_guard

from paddle_tpu_torch.monitor.registry import REGISTRY as TREGISTRY
from paddle_tpu_torch.serving import frontdoor as tfd
from paddle_tpu_torch.serving import resilience as tres
from paddle_tpu_torch.serving import scheduler as tsch
from paddle_tpu_torch.serving import InferenceServer as TServer
from paddle_tpu_torch.serving import ServingConfig as TConfig

TOL = 1e-5
CPU = torch.device("cpu")
HTTP_OUTCOMES = ("ok", "bad_request", "timeout", "deadline", "overloaded",
                 "queue_full", "tenant_quota", "tenant_fair_share",
                 "draining", "closed", "replica_lost", "disconnect",
                 "internal")

JAX = types.SimpleNamespace(fd=jfd, res=jres, sch=jsch, reg=JREGISTRY,
                            Server=JServer, Config=JConfig, dev={})
PORT = types.SimpleNamespace(fd=tfd, res=tres, sch=tsch, reg=TREGISTRY,
                             Server=TServer, Config=TConfig,
                             dev={"devices": [CPU]})


@pytest.fixture(autouse=True)
def _eager_mode():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        with static_mode_guard(False):
            yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def mlp_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("frontdoor") / "mlp")
    with static_mode_guard(False):
        main, startup = jpt.Program(), jpt.Program()
        with jpt.program_guard(main, startup), junique.guard():
            x = jpt.data("x", [256], "float32")
            h = jpt.layers.fc(x, 256, act="relu")
            h = jpt.layers.fc(h, 256, act="relu")
            out = jpt.layers.fc(h, 10)
        scope = jpt.static.Scope()
        with jpt.static.scope_guard(scope):
            exe = jpt.Executor()
            exe.run(startup)
            jpt.io.save_inference_model(d, ["x"], [out], exe,
                                        main_program=main)
            prog, feeds, fetches = jpt.io.load_inference_model(
                d, exe, scope=jpt.static.Scope())
        jinf.export_aot(d, prog, feeds, fetches, scope,
                        [{"x": ((1, 256), "float32")}])
    return d


def _http(P, outcome):
    m = P.reg.get("serving_http_requests_total")
    return m.value(outcome=outcome) if m is not None else 0.0


def _snap(P):
    return {o: _http(P, o) for o in HTTP_OUTCOMES}


def _wait(cond, timeout=10.0):
    t_end = time.monotonic() + timeout
    while time.monotonic() < t_end:
        if cond():
            return True
        time.sleep(0.01)
    return False


class _Recording:
    """A stand-in server of one package's types: answers ``x * 2``, raises
    ``fail_with``, or holds its answer until ``gate`` is set."""

    model_version = "stand-in"
    draining = False

    def __init__(self, P, fail_with=None, gate=None):
        self.P, self.fail_with, self.gate = P, fail_with, gate

    def submit(self, feeds, deadline_ms=None, trace_attrs=None):
        if self.fail_with is not None:
            raise self.fail_with
        p = self.P.sch.PendingResult()
        if self.gate is None:
            p._deliver(outs=[feeds["x"] * 2.0])
        else:
            threading.Thread(target=lambda: (
                self.gate.wait(10), p._deliver(outs=[feeds["x"] * 2.0])),
                daemon=True).start()
        return p

    def begin_drain(self):
        return True

    def close(self, timeout=None):
        return True


def _raw(port, data, timeout=5.0):
    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as s:
        s.sendall(data)
        s.settimeout(timeout)
        chunks = []
        try:
            while True:
                c = s.recv(65536)
                if not c:
                    break
                chunks.append(c)
        except (TimeoutError, socket.timeout):
            pass
    raw = b"".join(chunks)
    head = raw.split(b"\r\n\r\n", 1)[0].decode("latin-1").split("\r\n")
    hdrs = {k.strip().lower(): v.strip() for k, _, v in
            (ln.partition(":") for ln in head[1:])}
    return int(head[0].split()[1]), hdrs


def _door(P, server, **cfg):
    cfg.setdefault("socket_timeout_s", 5.0)
    return P.fd.HttpFrontDoor(server, P.fd.FrontDoorConfig(**cfg)).start()


def _sequence(P, d):
    """[(label, status, retry-after header, outcome deltas)] and the served
    output."""
    rows = []

    def record(label, fn):
        before = _snap(P)
        status, hdrs = fn()
        want_count = label != "disconnect"
        if want_count:
            assert _wait(lambda: sum(_snap(P).values()) > sum(
                before.values())), label
        after = _snap(P)
        rows.append((label, status, hdrs.get("retry-after"),
                     {o: after[o] - before[o] for o in HTTP_OUTCOMES
                      if after[o] != before[o]}))

    x = np.random.RandomState(0).rand(1, 256).astype(np.float32)
    srv = P.Server(d, P.Config(max_batch=2, max_wait_ms=1.0, **P.dev))
    door = _door(P, srv, max_body_bytes=1 << 16, socket_timeout_s=0.5)
    served = {}
    try:
        c = P.fd.WireClient("127.0.0.1", door.port)

        def ok():
            st, hdrs, payload = c.infer({"x": x}, tenant="a",
                                        deadline_ms=30_000)
            served["out"] = np.asarray(payload["outputs"][0], np.float32)
            served["version"] = payload["model_version"]
            return st, hdrs

        record("ok", ok)
        record("bad json", lambda: c.request("POST", "/v1/infer",
                                             b"{not json", {})[:2])
        record("too big", lambda: _raw(
            door.port, b"POST /v1/infer HTTP/1.1\r\nHost: x\r\n"
            b"Content-Length: 100000\r\n\r\n{}"))
        body = b'{"feeds": {"x": [[1.0]]}}'
        record("stalled", lambda: _raw(
            door.port, b"POST /v1/infer HTTP/1.1\r\nHost: x\r\n"
            + f"Content-Length: {len(body)}\r\n\r\n".encode()
            + body[:len(body) // 2]))
        c.close()
        # a fresh connection: the stall outlasted the idle keep-alive's
        # socket timeout
        with P.fd.WireClient("127.0.0.1", door.port) as c:
            record("deadline", lambda: c.infer({"x": x}, deadline_ms=0)[:2])
    finally:
        door.stop()
        assert srv.close(timeout=60)
    assert served["version"] == srv.model_version

    for label, err in (("queue full", P.sch.QueueFullError("full")),
                       ("overloaded", P.res.OverloadedError("shed"))):
        door = _door(P, _Recording(P, fail_with=err))
        try:
            with P.fd.WireClient("127.0.0.1", door.port) as c:
                record(label, lambda: c.infer({"x": [[1.0]]})[:2])
        finally:
            door.stop()

    gate = threading.Event()
    door = _door(P, _Recording(P, gate=gate), max_tenant_inflight=1)
    try:
        held = {}
        t = threading.Thread(target=lambda: held.update(r=P.fd.WireClient(
            "127.0.0.1", door.port, timeout_s=15).infer(
                {"x": [[1.0]]}, tenant="acme")))
        t.start()
        assert _wait(lambda: door.tenants.inflight("acme") == 1)
        with P.fd.WireClient("127.0.0.1", door.port) as c:
            record("tenant quota", lambda: c.infer({"x": [[1.0]]},
                                                   tenant="acme")[:2])
        gate.set()
        t.join(10)
        rows.append(("held", held["r"][0], held["r"][2]["outputs"]))
        # a client that hangs up while its result is awaited
        gate.clear()
        before = _snap(P)
        c = P.fd.WireClient("127.0.0.1", door.port).connect()
        c._send((f"POST /v1/infer HTTP/1.1\r\nHost: x\r\nX-Tenant: ghost"
                 f"\r\nContent-Length: {len(body)}\r\n\r\n").encode(), body)
        assert _wait(lambda: door.tenants.inflight("ghost") == 1)
        c.close()
        assert _wait(lambda: door.tenants.inflight("ghost") == 0)
        assert _wait(lambda: _http(P, "disconnect") > before["disconnect"])
        rows.append(("disconnect", _http(P, "disconnect")
                     - before["disconnect"], door.inflight))
        door.begin_drain()
        with P.fd.WireClient("127.0.0.1", door.port) as c:
            record("draining", lambda: c.infer({"x": [[1.0]]})[:2])
            rows.append(("readyz", c.get("/readyz")[0],
                         c.get("/healthz")[0]))
    finally:
        gate.set()
        door.stop()
    return rows, served["out"]


def test_request_sequence_like_jax(mlp_dir):
    want, wout = _sequence(JAX, mlp_dir)
    got, gout = _sequence(PORT, mlp_dir)
    assert got == want
    assert [r[:3] for r in want if len(r) == 4] == [
        ("ok", 200, None), ("bad json", 400, None), ("too big", 413, None),
        ("stalled", 408, None), ("deadline", 504, None),
        ("queue full", 429, "1"), ("overloaded", 429, "1"),
        ("tenant quota", 429, "1"), ("draining", 503, "5")]
    assert [r[3] for r in want if len(r) == 4] == [
        {"ok": 1}, {"bad_request": 1}, {"bad_request": 1}, {"timeout": 1},
        {"deadline": 1}, {"queue_full": 1}, {"overloaded": 1},
        {"tenant_quota": 1}, {"draining": 1}]
    assert dict((r[0], r[1:]) for r in want if len(r) == 3) == {
        "held": (200, [[[2.0]]]), "disconnect": (1, 0), "readyz": (503, 200)}
    assert gout.shape == wout.shape == (1, 10)
    np.testing.assert_allclose(gout, wout, rtol=0,
                               atol=TOL * float(np.abs(wout).max()))


def test_tenant_counters_and_trace_attrs_like_jax(mlp_dir):
    """A tenant's admitted requests land in ``serving_tenant_requests_total``
    and its in-flight gauge series is removed at zero, in both packages;
    the port's kept trace carries the tenant and the transport."""
    from paddle_tpu_torch.monitor import trace as ttrace
    got = {}
    for P in (JAX, PORT):
        m = P.reg.get("serving_tenant_requests_total")
        before = m.value(tenant="t1") if m is not None else 0.0
        srv = _Recording(P)
        door = _door(P, srv)
        try:
            with P.fd.WireClient("127.0.0.1", door.port) as c:
                sts = [c.infer({"x": [[1.0]]}, tenant="t1")[0]
                       for _ in range(3)]
        finally:
            door.stop()
        m = P.reg.get("serving_tenant_requests_total")
        g = P.reg.get("serving_tenant_inflight")
        got[P is PORT] = (sts, m.value(tenant="t1") - before,
                          ("t1",) in g.samples())
    assert got[True] == got[False] == ([200] * 3, 3.0, False)
    old = ttrace.TRACER
    ttrace.enable(sample_rate=1.0)
    try:
        srv = TServer(mlp_dir, TConfig(max_batch=2, devices=[CPU]))
        door = _door(PORT, srv)
        try:
            with tfd.WireClient("127.0.0.1", door.port) as c:
                st, _, payload = c.infer(
                    {"x": np.zeros((1, 256), np.float32)}, tenant="t2")
        finally:
            door.stop()
            srv.close(timeout=60)
        assert st == 200
        root = [s for s in ttrace.spans(payload["trace_id"])
                if s["kind"] == "root"]
        assert root and root[0]["attrs"] == {"tenant": "t2",
                                             "transport": "http"}
    finally:
        ttrace.disable()
        ttrace.TRACER = old
