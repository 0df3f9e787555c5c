"""Cross-trainer sample exchange for global shuffle; the port of
``paddle_tpu/dataio/sample_exchange.py`` (stdlib sockets and the port's
copy of the wire protocol, so trainers of either package exchange).

Parity: Dataset::GlobalShuffle's trainer-to-trainer redistribution
(ref: paddle/fluid/framework/data_set.h:82-92 + data_set.cc
GlobalShuffle — each sample is hashed to an owning trainer and SENT
there over the fleet's RPC substrate). Here the transport is the
framed binary wire protocol (distributed/wire.py — fixed schemas, no
pickle): every trainer listens on its own endpoint, ships each
non-owned sample batch to its owner as SHUFFLE_PUSH frames (npz-packed
sample blobs), finishes with SHUFFLE_DONE carrying the sent count, and
collects until every peer's DONE arrived.
"""

import io
import os
import socket
import threading
import time

import numpy as np

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.distributed import wire

__all__ = ["exchange_samples", "sample_hash",
           "resolve_exchange_endpoints"]

_CHUNK = 512            # samples per SHUFFLE_PUSH frame


def sample_hash(sample):
    """Deterministic content hash shared by all trainers: ownership
    keys on sample CONTENT, never load position, so every trainer
    agrees regardless of per-trainer filelist partitioning (and of
    reader implementation — the native loader's order is deterministic
    nowadays, but trainers legitimately load different file sets)."""
    import hashlib
    key = b"|".join(np.asarray(a).tobytes() for a in sample)
    return int(hashlib.md5(key).hexdigest(), 16)


def _pack(samples):
    """A sample list as the structural npz blob of
    ``dataio/common.py``'s ``_npz_dump`` (no pickle)."""
    arrays = {}
    for i, sample in enumerate(samples):
        if not isinstance(sample, (tuple, list)):
            sample = (sample,)
        for j, field in enumerate(sample):
            arr = np.asarray(field)
            if arr.dtype == object:
                # np.savez would pickle it, and the loader refuses pickles
                raise TypeError(
                    f"sample {i} field {j} is object-dtype (ragged/"
                    "non-numeric); convert fields to rectangular arrays")
            arrays[f"s{i}_f{j}"] = arr
        arrays[f"s{i}_n"] = np.asarray(len(sample))
    buf = io.BytesIO()
    np.savez(buf, n=np.asarray(len(samples)), **arrays)
    return np.frombuffer(buf.getvalue(), np.uint8)


def _unpack(blob):
    with np.load(io.BytesIO(np.asarray(blob, np.uint8).tobytes())) as z:
        return [tuple(z[f"s{i}_f{j}"] for j in range(int(z[f"s{i}_n"])))
                for i in range(int(z["n"]))]


def _send_frame(sock, kind, fields):
    wire.send_frame(sock, kind, fields)


def _recv_frame(sock):
    kind, _, _, fields = wire.recv_frame(sock)
    return kind, fields


def resolve_exchange_endpoints(worker_endpoints):
    """The endpoints the sample exchange should BIND. In collective
    mode the trainer endpoints double as the process group's
    rendezvous (rank 0's is the coordinator — a long-lived bound
    port), so binding them again would EADDRINUSE; the launcher wires
    dedicated exchange ports as PADDLE_EXCHANGE_ENDPOINTS (launch.py,
    both modes eventually — PS mode's worker endpoints are already
    dedicated). Falls back to the worker endpoints when the env is
    absent or inconsistent."""
    env = os.environ.get("PADDLE_EXCHANGE_ENDPOINTS", "")
    eps = [e for e in env.split(",") if e]
    if len(eps) == len(worker_endpoints):
        return eps
    return list(worker_endpoints)


class _Listener:
    """Accept SHUFFLE_PUSH/DONE frames from peer trainers until every
    expected peer trainer id has delivered SHUFFLE_DONE.

    Completion is counted by DISTINCT trainer ids that sent DONE — not
    by raw accepted connections: a stray connection (port scanner,
    health check) or a peer reconnecting after a transient drop must
    not consume a peer slot and stall the exchange."""

    def __init__(self, endpoint, n_peers, timeout=120.0):
        host, port = endpoint.rsplit(":", 1)
        self.srv = socket.socket()
        self.srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.srv.bind((host, int(port)))
        self.srv.listen(max(n_peers, 1))
        # short accept timeout: the accept loop re-checks completion
        # between accepts instead of blocking the full deadline
        self.srv.settimeout(0.25)
        self.n_peers = n_peers
        self.timeout = timeout
        self.received = []
        self.counts = {}            # from_trainer -> received count
        self.done_ids = set()       # trainer ids that sent DONE
        self.errors = []            # fatal: integrity violations
        self.conn_errors = []       # soft: per-connection transport
        self._lock = threading.Lock()
        self._active_conns = 0      # serve threads currently running
        # INACTIVITY deadline, not absolute: steady frame traffic (a
        # large exchange legitimately outlasting `timeout` wall-clock)
        # keeps the listener alive; only `timeout`s of silence ends it
        self._last_activity = time.time()
        self._accept_thread = threading.Thread(target=self._accept,
                                               daemon=True)
        self._accept_thread.start()

    def _touch(self):
        self._last_activity = time.time()

    def _finished(self):
        """Accept loop exit condition: all peers DONE, or a fatal
        integrity error (no point waiting out the timeout on those)."""
        with self._lock:
            return (len(self.done_ids) >= self.n_peers
                    or bool(self.errors))

    def _accept(self):
        while not self._finished():
            # the inactivity clock only advances per COMPLETED frame,
            # so a single large frame mid-transfer must not trip it:
            # while any serve thread runs, its socket's own timeout
            # (recv raises after `timeout` of zero bytes) is the
            # liveness bound, and the thread's exit re-checks here
            with self._lock:
                quiet = (self._active_conns == 0
                         and time.time() - self._last_activity
                         > self.timeout)
            if quiet:
                return
            try:
                conn, _ = self.srv.accept()
            except socket.timeout:
                continue
            except OSError:         # pragma: no cover - closed socket
                return
            self._touch()
            conn.settimeout(self.timeout)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn):
        staged = []                 # pushes buffered until DONE
        with self._lock:
            self._active_conns += 1
        try:
            with conn:
                while True:
                    kind, fields = _recv_frame(conn)
                    self._touch()
                    if kind == wire.SHUFFLE_PUSH:
                        staged.extend(_unpack(fields[1]))
                    elif kind == wire.SHUFFLE_DONE:
                        tid, total = int(fields[0]), int(fields[1])
                        with self._lock:
                            got = self.counts.get(tid, 0) + len(staged)
                            if got != total:
                                self.errors.append(RuntimeError(
                                    f"trainer {tid} claimed {total} "
                                    f"samples, received {got}"))
                                return
                            self.received.extend(staged)
                            self.counts[tid] = got
                            self.done_ids.add(tid)
                        return
                    else:
                        self.errors.append(RuntimeError(
                            f"unexpected frame kind {kind}"))
                        return
        except Exception as e:
            # a dropped/garbled connection is only fatal if its peer
            # never completes (it may reconnect and resend the whole
            # bucket); its staged pushes die with this frame, so a
            # resend cannot double-count
            with self._lock:
                self.conn_errors.append(e)
        finally:
            with self._lock:
                self._active_conns -= 1
            self._touch()       # thread exit restarts the quiet clock

    def wait(self):
        # the accept thread exits on completion, fatal error, or
        # `timeout` of inactivity — join without a cap of our own so
        # an active transfer extends the wait (progress, not wall
        # clock, is the liveness signal)
        while self._accept_thread.is_alive():
            self._accept_thread.join(1.0)
        self.srv.close()
        with self._lock:
            if self.errors:
                raise self.errors[0]
            complete = len(self.done_ids) >= self.n_peers
        if not complete:
            err = (f"; first transport error: {self.conn_errors[0]!r}"
                   if self.conn_errors else "")
            raise TimeoutError(
                f"sample exchange incomplete after {self.timeout}s of "
                f"inactivity: {len(self.done_ids)}/{self.n_peers} "
                f"peers finished (done ids {sorted(self.done_ids)})"
                f"{err}")
        # all peers DONE: their serve threads have returned (DONE is
        # the last frame on the connection); stray connections hold
        # staged samples only in their own frames, so the set is final
        return self.received


def exchange_samples(samples, endpoints, trainer_id, hash_fn=None,
                     timeout=120.0):
    """Redistribute ``samples`` across the trainers at ``endpoints``:
    returns the samples OWNED by ``trainer_id`` (own retained + all
    received), where ownership is hash(sample) % n_trainers. Blocking
    collective: every trainer must call this with the same endpoint
    list."""
    n = len(endpoints)
    enforce(0 <= trainer_id < n, "trainer_id out of range")
    if n == 1:
        return list(samples)
    hash_fn = hash_fn or sample_hash
    by_owner = [[] for _ in range(n)]
    for s in samples:
        by_owner[hash_fn(s) % n].append(s)

    listener = _Listener(endpoints[trainer_id], n_peers=n - 1,
                         timeout=timeout)
    # ship every non-owned bucket to its owner; peers bring their
    # listeners up at slightly different times, so connects retry
    import time as _time

    def connect(ep):
        host, port = ep.rsplit(":", 1)
        t0 = _time.time()
        while True:
            try:
                return socket.create_connection((host, int(port)),
                                                timeout=timeout)
            except OSError:
                if _time.time() - t0 > timeout:
                    raise
                _time.sleep(0.1)

    for owner in range(n):
        if owner == trainer_id:
            continue
        sock = connect(endpoints[owner])
        try:
            bucket = by_owner[owner]
            for lo in range(0, len(bucket), _CHUNK):
                _send_frame(sock, wire.SHUFFLE_PUSH,
                            (trainer_id, _pack(bucket[lo:lo + _CHUNK])))
            _send_frame(sock, wire.SHUFFLE_DONE,
                        (trainer_id, len(bucket)))
        finally:
            sock.close()
    received = listener.wait()
    return by_owner[trainer_id] + received
