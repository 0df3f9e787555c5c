"""Shared threaded-HTTP plumbing: the lifecycle base under the serving
front door (``serving/frontdoor.py``) and the exporter's ``/metrics``
endpoint (``monitor/exporter.py``). The port's copy of
``paddle_tpu/monitor/httpd.py`` (stdlib only).

Both servers want the exact same shell — stdlib
``http.server.ThreadingHTTPServer`` on a daemon thread, ``port=0``
free-port pick, loopback-only default, bounded ``stop()``, and a
per-connection socket timeout so one stalled peer (a wedged scraper, a
slow-loris client) can never pin a handler thread forever. What
differs is only the handler, so subclasses supply exactly that via
:meth:`_handler_class` and inherit the rest.

The timeout rides stdlib mechanics: ``BaseHTTPRequestHandler.timeout``
makes ``setup()`` call ``connection.settimeout()``, so EVERY blocking
socket read/write in the handler — request line, headers, body, the
response write — is bounded. A timeout while *waiting between*
requests on a keep-alive connection just closes it (handled inside
``handle_one_request``); a timeout *mid-request* surfaces to the
handler, which can answer with a typed status before closing.
"""

import http.server
import threading

from paddle_tpu_torch.core.enforce import enforce

__all__ = ["ThreadedHTTPServerBase"]


class ThreadedHTTPServerBase:
    """Lifecycle shell for a threaded stdlib HTTP server.

    Subclasses implement ``_handler_class() -> BaseHTTPRequestHandler
    subclass``; the base wires the per-connection ``timeout`` and
    ``protocol_version`` class attributes onto it, binds the listener
    (``port=0`` picks a free port — read ``self.port`` after
    ``start()``), and runs ``serve_forever`` on a daemon thread.
    Loopback-only by default: both users of this base (metrics, the
    serving front door) expose process internals, so listening beyond
    the host is an explicit choice.

    ``socket_timeout_s`` bounds every blocking socket operation of
    every connection (None disables — not recommended; it restores
    the pin-a-thread-forever failure mode this base exists to close).
    """

    #: daemon-thread name, for operator-facing thread dumps
    thread_name = "pt-httpd"
    #: HTTP/1.1 so keep-alive works; requires every response to carry
    #: Content-Length (both subclasses do)
    protocol_version = "HTTP/1.1"

    def __init__(self, port=0, host="127.0.0.1", socket_timeout_s=10.0):
        enforce(socket_timeout_s is None or float(socket_timeout_s) > 0,
                f"socket_timeout_s must be > 0 or None, got "
                f"{socket_timeout_s!r}")
        self.host = host
        self.port = port
        self.socket_timeout_s = None if socket_timeout_s is None \
            else float(socket_timeout_s)
        self._httpd = None
        self._thread = None

    def _handler_class(self):
        raise NotImplementedError(
            "ThreadedHTTPServerBase subclasses supply the handler")

    @property
    def running(self):
        return self._httpd is not None

    def start(self):
        handler = self._handler_class()
        # class attrs, not instance: http.server instantiates the
        # handler itself, one per connection
        handler.timeout = self.socket_timeout_s
        handler.protocol_version = self.protocol_version
        # headers and body flush as separate segments; with Nagle on,
        # the body then waits out the peer's delayed ACK (~40ms flat
        # per response on loopback) — TCP_NODELAY, always
        handler.disable_nagle_algorithm = True
        self._httpd = http.server.ThreadingHTTPServer(
            (self.host, self.port), handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name=self.thread_name)
        self._thread.start()
        return self

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False
