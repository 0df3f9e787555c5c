"""Per-rank heartbeat files — the elastic launcher's hang watchdog signal.
The port's own copy of ``paddle_tpu/distributed/health.py`` (stdlib only;
the same file names, so either package's launcher reads the other's
ranks).

Contract (consumed by ``launch._supervise`` and produced by training
loops): the launcher exports ``PADDLE_HEARTBEAT_DIR`` to every child it
spawns; a child that wants hang protection touches
``<dir>/rank<PADDLE_TRAINER_ID>.hb`` at least once per watchdog period
(``auto_checkpoint`` does this automatically via ``Heartbeat.from_env``).
The launcher's wait loop reads the files' mtimes: a rank whose file
exists but has not been touched for ``--hang_timeout`` seconds is *hung*
(kill + restart the gang); a rank whose file never appeared is merely
*slow* — maybe a long startup, maybe a worker that does not heartbeat at
all — and is logged but never killed by the watchdog (the global
``timeout`` still bounds it). That asymmetry keeps ``--hang_timeout``
safe to enable for workers that never opt in.

Everything here is stdlib-only: the launcher must work without torch.
"""

import os
import re
import threading
import time

__all__ = ["Heartbeat", "heartbeat_path", "metrics_path", "last_beat",
           "stale_ranks", "silent_ranks", "reset", "sweep_stale_ranks",
           "ENV_DIR", "ENV_RANK"]

ENV_DIR = "PADDLE_HEARTBEAT_DIR"
ENV_RANK = "PADDLE_TRAINER_ID"


def heartbeat_path(dirname, rank):
    return os.path.join(dirname, f"rank{int(rank)}.hb")


def metrics_path(dirname, rank):
    """Where a rank's Prometheus snapshot lives: next to its heartbeat
    file, so the launcher finds both liveness and metrics in one place
    (written atomically by monitor.exporter.RankExporter; deliberately
    NOT cleared by reset() — a dead incarnation's last snapshot is
    evidence, not a liveness vouch)."""
    return os.path.join(dirname, f"rank{int(rank)}.prom")


class Heartbeat:
    """Touches this rank's heartbeat file; rate-limited so a tight
    training loop can call ``beat()`` every step for free.

    Use inline (``hb.beat()`` inside the loop body) or as a background
    thread (``hb.start()`` / ``hb.stop()``) for loops whose step time
    may legitimately exceed the watchdog period — note the thread
    variant only proves the *process* is alive, not the loop.
    """

    def __init__(self, dirname, rank, interval=1.0):
        self.dirname = dirname
        self.rank = int(rank)
        self.path = heartbeat_path(dirname, rank)
        self.interval = float(interval)
        self._last = None           # None: the first beat always fires
        self._stop = threading.Event()
        self._thread = None
        os.makedirs(dirname, exist_ok=True)

    @classmethod
    def from_env(cls, env=None, interval=1.0):
        """The child-side hookup: a ``Heartbeat`` wired from the
        launcher's env, or None when not launched under a supervisor."""
        env = os.environ if env is None else env
        if not env.get(ENV_DIR):
            return None
        return cls(env[ENV_DIR], env.get(ENV_RANK, "0"), interval=interval)

    def beat(self, force=False):
        """Touch the file (rate-limited to ``interval``). Returns True
        if the file was actually touched. Never raises: a dead disk
        must not kill the training loop it is meant to protect."""
        now = time.monotonic()
        if (not force and self._last is not None
                and now - self._last < self.interval):
            return False
        self._last = now
        try:
            with open(self.path, "a"):
                pass
            os.utime(self.path, None)
        except OSError:
            return False
        return True

    # -- background-thread variant ----------------------------------------
    def start(self):
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self.interval):
            self.beat(force=True)

    def stop(self):
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self):
        self.beat(force=True)
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


# -- launcher-side readers --------------------------------------------------
def last_beat(dirname, rank):
    """Wall-clock mtime of the rank's heartbeat file, or None if it
    never beat."""
    try:
        return os.stat(heartbeat_path(dirname, rank)).st_mtime
    except OSError:
        return None


def stale_ranks(dirname, nranks, timeout, now=None):
    """Ranks that heartbeat at least once and then stopped: list of
    (rank, age_seconds) with age > timeout. These are *hung*."""
    now = time.time() if now is None else now
    out = []
    for r in range(nranks):
        lb = last_beat(dirname, r)
        if lb is not None and now - lb > timeout:
            out.append((r, now - lb))
    return out


def silent_ranks(dirname, nranks):
    """Ranks whose heartbeat file never appeared — *slow* (or not
    heartbeating at all); the watchdog logs but does not kill these."""
    return [r for r in range(nranks) if last_beat(dirname, r) is None]


def reset(dirname, nranks):
    """Clear all heartbeat files (between gang restarts, so a dead
    incarnation's beats cannot vouch for the new one)."""
    for r in range(nranks):
        try:
            os.remove(heartbeat_path(dirname, r))
        except OSError:
            pass


_RANK_FILE_RE = re.compile(r"^rank(\d+)\.(hb|prom)$")


def sweep_stale_ranks(dirname, nranks):
    """Remove the heartbeat AND metrics files of ranks >= ``nranks`` —
    leftovers of a previous, larger incarnation. An elastic shrink
    otherwise leaves ``rank<N>.prom`` polluting the aggregated
    ``metrics.prom``/status line forever (the dead rank's counters keep
    being summed in) and a stale ``rank<N>.hb`` lying around for a
    later incarnation that grows back over the index. Unlike
    ``reset``, the ``.prom`` removal is deliberate: a rank that no
    longer EXISTS in the job is not evidence, it is noise. Scan-based
    (not ``range``) so any count of leftovers is caught. Returns the
    removed filenames."""
    removed = []
    try:
        names = os.listdir(dirname)
    except OSError:
        return removed
    for f in names:
        m = _RANK_FILE_RE.match(f)
        if m and int(m.group(1)) >= nranks:
            try:
                os.remove(os.path.join(dirname, f))
                removed.append(f)
            except OSError:
                pass
    return sorted(removed)
