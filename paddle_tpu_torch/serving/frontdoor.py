"""HTTP/1.1 front door: the serving stack's network boundary. The port of
``paddle_tpu/serving/frontdoor.py`` (stdlib and numpy), over
:meth:`InferenceServer.submit`, on the ``monitor/httpd.py`` base:

- **Deadline propagation**: an ``X-Deadline-Ms`` header anchors the
  absolute deadline at the request line's arrival on the socket; the wire
  and parse time is spent by the time the body is parsed, so the scheduler
  receives the REMAINING budget through ``submit(deadline_ms=)``. Every
  typed serving error maps to a stable status code: 400 malformed, 408 a
  stalled body, 413 over ``max_body_bytes``, 429 ``queue_full`` /
  ``overloaded`` / tenant refusals (with ``Retry-After``), 503 draining
  (``Retry-After``) / closed / replica lost, 504 deadline, 500 internal.
- **Per-tenant admission**: the ``X-Tenant`` header keys bounded per-tenant
  in-flight quotas and a brownout fair-share layer
  (:class:`~.resilience.TenantFairShare`) over the shed controller. The
  tenant rides the request's kept trace (``submit(trace_attrs=)``).
- **Connection robustness**: per-connection socket timeouts, a bounded
  body, and a ``MSG_PEEK`` probe for a client that hung up while its result
  was awaited (its tenant slot is released, not leaked). ``/healthz`` says
  the listener is alive; ``/readyz`` flips with the drain.
- **Graceful drain**: ``begin_drain()`` (or SIGTERM through
  :meth:`HttpFrontDoor.install_signal_handlers`) flips readiness, new
  requests get 503 + Retry-After, in-flight ones complete, and
  :meth:`drain` is bounded and loud.

The wire format is the JAX package's: ``POST /v1/infer`` with
``{"feeds": {name: nested list}}`` answers ``{"outputs": [...],
"model_version": ..., "trace_id": ...}``; ``model_version`` names the
version whose pool computed the answer (the JAX front door writes the
server's version at response time, which names the next version for a
request computed just before a cutover). The env-driven wire-fault
installers that patch :meth:`WireClient._send` are ROADMAP queue 1 item 10.
"""

import json
import select
import signal
import socket
import threading
import time

import numpy as np

from paddle_tpu_torch.core.enforce import EnforceNotMet, enforce
from paddle_tpu_torch.monitor.httpd import ThreadedHTTPServerBase
from paddle_tpu_torch.monitor.registry import counter, gauge, histogram
from paddle_tpu_torch.serving.resilience import (
    DeadlineExceededError, OverloadedError, ReplicaLostError,
    TenantFairShare, _log,
)
from paddle_tpu_torch.serving.scheduler import (
    QueueFullError, ServerClosedError, ServerDrainingError,
)

__all__ = [
    "FrontDoorConfig", "HttpFrontDoor", "WireClient", "WireReset",
]

_m_http = counter(
    "serving_http_requests_total",
    "Front-door HTTP requests by outcome: ok (200), bad_request "
    "(400/404/405/413/431 — malformed body, unknown path, oversized "
    "or bomb headers), timeout (408 slow-loris body read), deadline "
    "(504), overloaded (429 shed), queue_full (429 bounded queue), "
    "tenant_quota / tenant_fair_share (429 per-tenant admission), "
    "draining (503 + Retry-After), closed (503 terminal), "
    "replica_lost (503 retryable), disconnect (client gone before "
    "the response could be delivered), internal (500)",
    labels=("outcome",))
_m_http_ms = histogram(
    "serving_http_request_ms",
    "Front-door request wall time in milliseconds: request-line "
    "arrival on the socket -> response written (wire parse + "
    "admission + queue + execute + serialization); compare with "
    "serving_request_latency_ms to attribute wire overhead")
_m_http_inflight = gauge(
    "serving_http_inflight",
    "HTTP requests currently inside the front door (admitted into a "
    "handler thread, response not yet written)")
_m_http_draining = gauge(
    "serving_http_draining",
    "1 while the front door is draining (refusing new requests with "
    "503 + Retry-After while in-flight requests complete), else 0")
_m_tenant_requests = counter(
    "serving_tenant_requests_total",
    "Front-door requests per tenant (the X-Tenant header, "
    "default_tenant when absent) that passed tenant admission",
    labels=("tenant",))
_m_tenant_inflight = gauge(
    "serving_tenant_inflight",
    "In-flight front-door requests per tenant; series are removed at "
    "zero so idle tenants do not accumulate export cardinality",
    labels=("tenant",))
_m_tenant_refused = counter(
    "serving_tenant_refused_total",
    "Tenant admission refusals by reason: quota (the tenant already "
    "holds max_tenant_inflight requests), fair_share (brownout "
    "squeeze — admitting would push the tenant past fair_frac of all "
    "in-flight requests)",
    labels=("reason",))


class FrontDoorConfig:
    """Knobs for :class:`HttpFrontDoor` (docs/SERVING.md has the
    operator table). Defaults are loopback, 10s socket timeout, 8 MiB
    body bound, 64 in-flight per tenant."""

    def __init__(self, port=0, host="127.0.0.1", socket_timeout_s=10.0,
                 max_body_bytes=8 << 20, tenant_header="X-Tenant",
                 default_tenant="anonymous", max_tenant_inflight=64,
                 fair_frac=0.5, fair_min_inflight=4, retry_after_s=1.0,
                 drain_retry_after_s=5.0, drain_timeout_s=30.0,
                 result_timeout_s=600.0):
        enforce(int(max_body_bytes) >= 1,
                f"max_body_bytes must be >= 1, got {max_body_bytes!r}")
        enforce(float(result_timeout_s) > 0,
                f"result_timeout_s must be > 0, got "
                f"{result_timeout_s!r} — it is the front door's "
                f"last-ditch hang bound for deadline-less requests")
        self.port = port
        self.host = host
        self.socket_timeout_s = socket_timeout_s
        self.max_body_bytes = int(max_body_bytes)
        self.tenant_header = tenant_header
        self.default_tenant = default_tenant
        self.max_tenant_inflight = int(max_tenant_inflight)
        self.fair_frac = float(fair_frac)
        self.fair_min_inflight = int(fair_min_inflight)
        self.retry_after_s = float(retry_after_s)
        self.drain_retry_after_s = float(drain_retry_after_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self.result_timeout_s = float(result_timeout_s)


class _ClientGone(Exception):
    """Internal: the client hung up while we held its request."""


class HttpFrontDoor(ThreadedHTTPServerBase):
    """The production HTTP boundary over one
    :class:`~.server.InferenceServer`.

    ``POST /v1/infer`` with a JSON body ``{"feeds": {name: nested
    list}}`` returns ``{"outputs": [...], "model_version": ...,
    "trace_id": ...}``; ``GET /healthz`` / ``GET /readyz`` are the
    probe pair. Every response carries a stable status code mapped
    from the serving stack's typed errors, and every request lands in
    ``serving_http_requests_total`` under exactly one outcome — the
    wire-level mirror of the scheduler's accounting invariant.
    """

    thread_name = "pt-serving-frontdoor"

    def __init__(self, server, config=None):
        self.config = config or FrontDoorConfig()
        super().__init__(port=self.config.port, host=self.config.host,
                         socket_timeout_s=self.config.socket_timeout_s)
        self.server = server
        # the fair-share layer reads the LIVE shed controller so the
        # brownout squeeze and the scheduler's own shedding trip
        # together; servers without one (shed_mode off, test fakes)
        # just never fair-share
        self.tenants = TenantFairShare(
            max_inflight=self.config.max_tenant_inflight,
            fair_frac=self.config.fair_frac,
            fair_min_inflight=self.config.fair_min_inflight,
            shed=getattr(getattr(server, "scheduler", None), "_shed",
                         None))
        self._draining = False
        self._inflight = 0
        self._flock = threading.Lock()
        _m_http_draining.set(0)
        _m_http_inflight.set(0)

    # -- drain lifecycle ---------------------------------------------------
    @property
    def draining(self):
        return self._draining

    @property
    def inflight(self):
        return self._inflight

    def ready(self):
        """The /readyz verdict: listening and not draining (front
        door OR server — a server mid-drain must stop attracting
        traffic even if the front door was not told directly)."""
        return self.running and not self._draining and \
            not getattr(self.server, "draining", False)

    def begin_drain(self, why="begin_drain"):
        """Flip the front door into draining: /readyz goes 503, every
        new request gets 503 + Retry-After, in-flight requests keep
        completing. Also begins the server's own drain so in-process
        callers see the retryable ``ServerDrainingError``. Idempotent;
        returns whether THIS call flipped the state."""
        with self._flock:
            if self._draining:
                return False
            self._draining = True
        _m_http_draining.set(1)
        _log(f"front door draining ({why}): /readyz now 503, new "
             f"requests refused 503 + Retry-After "
             f"{self.config.drain_retry_after_s:.0f}s; "
             f"{self._inflight} in flight completing")
        if hasattr(self.server, "begin_drain"):
            self.server.begin_drain()
        return True

    def drain(self, timeout_s=None, close=True):
        """Bounded, loud graceful shutdown: begin the drain, wait up
        to ``timeout_s`` (config ``drain_timeout_s``) for in-flight
        requests to finish, then close the server (its own drain
        contract completes accepted work) and stop the listener.
        Returns True when every in-flight request finished inside the
        bound — False means the bound expired with stragglers, and
        the log line says how many."""
        self.begin_drain(why="drain")
        bound = self.config.drain_timeout_s if timeout_s is None \
            else float(timeout_s)
        t_end = time.monotonic() + bound
        while self._inflight > 0 and time.monotonic() < t_end:
            time.sleep(0.02)
        drained = self._inflight == 0
        if drained:
            _log("front door drain complete: 0 in flight")
        else:
            _log(f"front door drain TIMED OUT after {bound:.1f}s: "
                 f"{self._inflight} request(s) still in flight "
                 f"(daemon handler threads; responses may still land)")
        if close and hasattr(self.server, "close"):
            self.server.close()
        self.stop()
        return drained

    def install_signal_handlers(self, signals=(signal.SIGTERM,)):
        """SIGTERM -> background :meth:`drain` (the rolling-restart
        contract: the orchestrator sends SIGTERM, readiness flips,
        in-flight completes, process exits cleanly). Returns the
        previous handler map for restoration; main-thread only (a
        no-op with a loud line elsewhere, so embedding in a worker
        thread degrades visibly rather than raising)."""
        prev = {}
        for sig in signals:
            try:
                prev[sig] = signal.signal(
                    sig, lambda *_a: threading.Thread(
                        target=self.drain, name="pt-frontdoor-drain",
                        daemon=True).start())
            except ValueError:
                _log(f"front door: cannot install handler for "
                     f"{sig!r} off the main thread; call "
                     f"begin_drain()/drain() directly")
        return prev

    def _enter(self):
        with self._flock:
            self._inflight += 1
            _m_http_inflight.set(self._inflight)

    def _exit(self):
        with self._flock:
            self._inflight -= 1
            _m_http_inflight.set(self._inflight)

    # -- the handler -------------------------------------------------------
    def _handler_class(self):
        import http.server

        door = self

        class Handler(http.server.BaseHTTPRequestHandler):
            server_version = "paddle-tpu-frontdoor"
            sys_version = ""

            # ---- plumbing ----
            def parse_request(self):
                # the deadline anchor: request-line arrival on the
                # socket (~= accept for fresh connections; keep-alive
                # idle time between requests is deliberately NOT
                # charged against the next request's budget)
                self._t_anchor = time.perf_counter()
                return super().parse_request()

            def log_message(self, *a):
                pass                   # metrics + _log, not stderr spam

            def send_error(self, code, message=None, explain=None):
                # stdlib-generated refusals (431 header bomb, 414,
                # 501...) and our own 404/405 funnel through here:
                # count them so every wire request lands in the
                # accounting, then answer; a client that vanished
                # mid-refusal flips the count to disconnect
                if code >= 400:
                    _m_http.inc(outcome="bad_request")
                try:
                    super().send_error(code, message, explain)
                except OSError:
                    self.close_connection = True

            def _client_gone(self):
                """Probe the connection without consuming request
                data: a readable-but-empty socket means the client
                closed; nothing to read means it is still there.
                select() with a zero timeout first — a bare
                recv(MSG_DONTWAIT) would still park in the socket
                timeout's readiness wait and misreport a healthy
                but silent client as gone."""
                try:
                    readable, _, _ = select.select(
                        [self.connection], [], [], 0)
                    if not readable:
                        return False
                    chunk = self.connection.recv(
                        1, socket.MSG_PEEK | socket.MSG_DONTWAIT)
                except (BlockingIOError, InterruptedError):
                    return False
                except (OSError, ValueError):
                    return True
                return chunk == b""

            def _finish(self, status, payload, outcome,
                        retry_after=None, t0=None):
                """Send one JSON response and count EXACTLY one
                outcome for the request — a write failure converts
                the outcome to disconnect rather than double-count."""
                body = json.dumps(payload).encode("utf-8")
                try:
                    self.send_response(status)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    if retry_after is not None:
                        self.send_header(
                            "Retry-After",
                            str(max(1, int(round(retry_after)))))
                    if self.close_connection:
                        self.send_header("Connection", "close")
                    self.end_headers()
                    self.wfile.write(body)
                except (TimeoutError, socket.timeout, OSError):
                    outcome = "disconnect"
                    self.close_connection = True
                _m_http.inc(outcome=outcome)
                if t0 is not None:
                    _m_http_ms.observe(
                        (time.perf_counter() - t0) * 1e3)

            def _probe(self, body, status=200):
                """Uncounted plumbing response (health probes): a
                kubelet scraping /healthz every 2s must not dominate
                serving_http_requests_total."""
                data = body.encode("utf-8")
                self.send_response(status)
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(data)))
                if status == 503:
                    self.send_header(
                        "Retry-After",
                        str(max(1, int(round(
                            door.config.drain_retry_after_s)))))
                self.end_headers()
                self.wfile.write(data)

            # ---- routes ----
            def do_GET(self):
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                if path == "/healthz":
                    self._probe("ok\n")
                elif path == "/readyz":
                    if door.ready():
                        self._probe("ready\n")
                    else:
                        self._probe("draining\n", status=503)
                elif path == "/v1/infer":
                    self.send_error(405, "POST /v1/infer")
                else:
                    self.send_error(404)

            def do_POST(self):
                path = self.path.split("?", 1)[0].rstrip("/")
                if path != "/v1/infer":
                    self.send_error(404)
                    return
                door._enter()
                try:
                    self._infer(getattr(self, "_t_anchor",
                                        time.perf_counter()))
                finally:
                    door._exit()

            # ---- the request pipeline ----
            def _read_body(self, t0):
                """Bounded, timeout-typed body read. Returns bytes or
                None after having fully answered (and counted) the
                request."""
                raw_len = self.headers.get("Content-Length")
                if raw_len is None:
                    self._finish(400, {"error": "Content-Length "
                                       "required"},
                                 outcome="bad_request", t0=t0)
                    return None
                try:
                    length = int(raw_len)
                    enforce(length >= 0, "negative Content-Length")
                except (ValueError, EnforceNotMet):
                    self._finish(400, {"error": f"bad Content-Length "
                                       f"{raw_len!r}"},
                                 outcome="bad_request", t0=t0)
                    return None
                if length > door.config.max_body_bytes:
                    self.close_connection = True
                    self._finish(413, {"error": f"body {length} bytes "
                                       f"exceeds max_body_bytes "
                                       f"{door.config.max_body_bytes}"},
                                 outcome="bad_request", t0=t0)
                    return None
                try:
                    body = self.rfile.read(length)
                except (TimeoutError, socket.timeout):
                    # slow-loris: the client stalled mid-body past the
                    # socket timeout; the byte stream is now torn, so
                    # answer typed and drop the connection
                    self.close_connection = True
                    self._finish(408, {"error": "body read timed out "
                                       "(slow client)"},
                                 outcome="timeout", t0=t0)
                    return None
                except OSError:
                    self.close_connection = True
                    _m_http.inc(outcome="disconnect")
                    return None
                if len(body) < length:
                    # EOF mid-body: client hung up; no one to answer
                    self.close_connection = True
                    _m_http.inc(outcome="disconnect")
                    return None
                return body

            def _parse(self, body):
                """-> (feeds, budget_ms, tenant); raises EnforceNotMet
                with the operator-facing message on any malformation
                (mapped to 400 by the caller)."""
                try:
                    payload = json.loads(body)
                except (ValueError, UnicodeDecodeError) as e:
                    raise EnforceNotMet(f"request body is not valid "
                                        f"JSON: {e}") from None
                enforce(isinstance(payload, dict) and
                        isinstance(payload.get("feeds"), dict) and
                        payload["feeds"],
                        'request body must be {"feeds": {name: '
                        'nested-list}} with at least one feed')
                feeds = {}
                for name, val in payload["feeds"].items():
                    try:
                        feeds[str(name)] = np.asarray(val)
                    except (ValueError, TypeError) as e:
                        raise EnforceNotMet(
                            f"feed {name!r} is not array-like: "
                            f"{e}") from None
                budget_ms = None
                raw = self.headers.get("X-Deadline-Ms")
                if raw is not None:
                    try:
                        budget_ms = float(raw)
                        enforce(budget_ms >= 0 and
                                budget_ms == budget_ms and
                                budget_ms != float("inf"),
                                "out of range")
                    except (ValueError, EnforceNotMet):
                        raise EnforceNotMet(
                            f"X-Deadline-Ms must be a finite "
                            f"non-negative number of milliseconds, "
                            f"got {raw!r}") from None
                tenant = (self.headers.get(door.config.tenant_header)
                          or "").strip() or door.config.default_tenant
                enforce(len(tenant) <= 128,
                        f"{door.config.tenant_header} header exceeds "
                        f"128 chars")
                return feeds, budget_ms, tenant

            def _await(self, pending, deadline_ms):
                """Wait for the result in short slices, probing for a
                client hangup between slices (a disconnected client's
                rider is released, not leaked). The overall bound is
                the request deadline plus slack — the scheduler's own
                deadline machinery fails the rider first in every
                healthy case; the bound only catches a broken stack."""
                if deadline_ms is not None:
                    bound_s = deadline_ms / 1e3 + 30.0
                else:
                    bound_s = door.config.result_timeout_s
                t_end = time.monotonic() + bound_s
                while True:
                    try:
                        return pending.result(timeout=0.05)
                    except TimeoutError:
                        pass
                    if self._client_gone():
                        raise _ClientGone()
                    if time.monotonic() >= t_end:
                        raise TimeoutError(
                            f"result not delivered within "
                            f"{bound_s:.1f}s (front-door bound; the "
                            f"scheduler's deadline should have fired "
                            f"first — this is a bug, not load)")

            def _infer(self, t0):
                body = self._read_body(t0)
                if body is None:
                    return
                retry_s = door.config.retry_after_s
                try:
                    feeds, budget_ms, tenant = self._parse(body)
                except EnforceNotMet as e:
                    self._finish(400, {"error": str(e)},
                                 outcome="bad_request", t0=t0)
                    return
                if door.draining or getattr(door.server, "draining",
                                            False):
                    self._finish(
                        503, {"error": "draining: retry against "
                              "another replica"},
                        outcome="draining",
                        retry_after=door.config.drain_retry_after_s,
                        t0=t0)
                    return
                verdict = door.tenants.admit(tenant)
                if verdict == "quota":
                    _m_tenant_refused.inc(reason="quota")
                    self._finish(
                        429, {"error": f"tenant {tenant!r} at "
                              f"max_tenant_inflight "
                              f"{door.tenants.max_inflight}"},
                        outcome="tenant_quota", retry_after=retry_s,
                        t0=t0)
                    return
                if verdict == "fair_share":
                    _m_tenant_refused.inc(reason="fair_share")
                    self._finish(
                        429, {"error": f"tenant {tenant!r} over fair "
                              f"share during brownout"},
                        outcome="tenant_fair_share",
                        retry_after=retry_s, t0=t0)
                    return
                _m_tenant_requests.inc(tenant=tenant)
                _m_tenant_inflight.set(door.tenants.inflight(tenant),
                                       tenant=tenant)
                try:
                    self._submit_and_respond(t0, feeds, budget_ms,
                                             tenant, retry_s)
                finally:
                    if door.tenants.release(tenant) == 0:
                        _m_tenant_inflight.remove(tenant=tenant)
                    else:
                        _m_tenant_inflight.set(
                            door.tenants.inflight(tenant),
                            tenant=tenant)

            def _submit_and_respond(self, t0, feeds, budget_ms,
                                    tenant, retry_s):
                try:
                    deadline_ms = None
                    if budget_ms is not None:
                        # the deduction: wire + parse time already
                        # spent against the budget anchored at t0; a
                        # zero remainder still goes to submit, where
                        # admission refuses it typed WITHOUT enqueueing
                        deadline_ms = max(
                            0.0, budget_ms -
                            (time.perf_counter() - t0) * 1e3)
                    pending = door.server.submit(
                        feeds, deadline_ms=deadline_ms,
                        trace_attrs={"tenant": tenant,
                                     "transport": "http"})
                    outs = self._await(pending, deadline_ms)
                except _ClientGone:
                    self.close_connection = True
                    _m_http.inc(outcome="disconnect")
                    return
                except EnforceNotMet as e:
                    self._finish(400, {"error": str(e)},
                                 outcome="bad_request", t0=t0)
                    return
                except DeadlineExceededError as e:
                    self._finish(504, {"error": str(e)},
                                 outcome="deadline", t0=t0)
                    return
                except ServerDrainingError as e:
                    self._finish(503, {"error": str(e)},
                                 outcome="draining",
                                 retry_after=(
                                     door.config.drain_retry_after_s),
                                 t0=t0)
                    return
                except ServerClosedError as e:
                    self._finish(503, {"error": str(e)},
                                 outcome="closed", t0=t0)
                    return
                except OverloadedError as e:
                    self._finish(429, {"error": str(e)},
                                 outcome="overloaded",
                                 retry_after=retry_s, t0=t0)
                    return
                except QueueFullError as e:
                    self._finish(429, {"error": str(e)},
                                 outcome="queue_full",
                                 retry_after=retry_s, t0=t0)
                    return
                except ReplicaLostError as e:
                    self._finish(503, {"error": str(e)},
                                 outcome="replica_lost",
                                 retry_after=retry_s, t0=t0)
                    return
                except Exception as e:
                    self._finish(500, {"error": f"{type(e).__name__}: "
                                       f"{e}"},
                                 outcome="internal", t0=t0)
                    return
                # the version that computed the result, as its pool
                # stamped it: across a cutover the server's current
                # version may already be the next one
                version = getattr(pending, "model_version", None)
                if version is None:
                    version = getattr(door.server, "model_version", None)
                self._finish(
                    200,
                    {"outputs": [np.asarray(o).tolist() for o in outs],
                     "model_version": version,
                     "trace_id": pending.trace_id},
                    outcome="ok", t0=t0)

        return Handler


class WireReset(RuntimeError):
    """The wire connection died mid-exchange (reset, EOF, injected
    disconnect): a TYPED wire-level resolution — the request's fate on
    the server is unknown, but the client call itself never hangs."""


class WireClient:
    """Minimal raw-socket HTTP/1.1 client for tests, chaos and bench
    (stdlib urllib would hide the socket, and the fault injector
    needs the seam): one persistent connection, blocking with a hard
    timeout, every failure surfacing as :class:`WireReset` or
    ``TimeoutError`` — never a hang."""

    def __init__(self, host, port, timeout_s=30.0):
        self.host = host
        self.port = int(port)
        self.timeout_s = float(timeout_s)
        self._sock = None

    # -- connection --------------------------------------------------------
    def connect(self):
        if self._sock is None:
            self._sock = socket.create_connection(
                (self.host, self.port), timeout=self.timeout_s)
            # mirror the server's TCP_NODELAY: a Nagle-held segment
            # against a delayed ACK costs ~40ms flat per request
            self._sock.setsockopt(socket.IPPROTO_TCP,
                                  socket.TCP_NODELAY, 1)
        return self

    def close(self):
        self._drop()

    def _drop(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def __enter__(self):
        return self.connect()

    def __exit__(self, *exc):
        self.close()
        return False

    # -- requests ----------------------------------------------------------
    def infer(self, feeds, deadline_ms=None, tenant=None, headers=None):
        """POST /v1/infer -> (status, headers, payload). ``feeds``
        maps name -> array-like (serialized via tolist)."""
        hdrs = dict(headers or ())
        if deadline_ms is not None:
            hdrs["X-Deadline-Ms"] = str(float(deadline_ms))
        if tenant is not None:
            hdrs["X-Tenant"] = tenant
        body = json.dumps(
            {"feeds": {k: np.asarray(v).tolist()
                       for k, v in feeds.items()}}).encode("utf-8")
        return self.request("POST", "/v1/infer", body, hdrs)

    def get(self, path):
        return self.request("GET", path, b"", {})

    def request(self, method, path, body, headers):
        self.connect()
        head_lines = [f"{method} {path} HTTP/1.1",
                      f"Host: {self.host}:{self.port}",
                      f"Content-Length: {len(body)}"]
        head_lines += [f"{k}: {v}" for k, v in headers.items()]
        head = ("\r\n".join(head_lines) + "\r\n\r\n").encode("utf-8")
        try:
            self._send(head, body)
            return self._recv_response()
        except (TimeoutError, socket.timeout):
            self._drop()
            raise
        except OSError as e:
            self._drop()
            raise WireReset(f"wire failure during {method} {path}: "
                            f"{e}") from e

    def _send(self, head, body):
        """THE fault-injection seam: a wire fault patches exactly this
        method."""
        self._sock.sendall(head + body)

    def _recv_file(self):
        return self._sock.makefile("rb")

    def _recv_response(self):
        f = self._recv_file()
        try:
            status_line = f.readline()
            if not status_line:
                self._drop()
                raise WireReset("connection closed before status line")
            parts = status_line.decode("latin-1").split(None, 2)
            status = int(parts[1])
            headers = {}
            while True:
                line = f.readline()
                if not line:
                    self._drop()
                    raise WireReset("connection closed mid-headers")
                line = line.decode("latin-1").strip()
                if not line:
                    break
                k, _, v = line.partition(":")
                headers[k.strip().lower()] = v.strip()
            length = int(headers.get("content-length", "0"))
            raw = f.read(length) if length else b""
            if len(raw) < length:
                self._drop()
                raise WireReset("connection closed mid-body")
        finally:
            f.close()
        if headers.get("connection", "").lower() == "close":
            self._drop()
        payload = None
        if raw:
            try:
                payload = json.loads(raw)
            except ValueError:
                payload = raw.decode("utf-8", "replace")
        return status, headers, payload
