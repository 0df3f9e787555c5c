"""The served model version's gauge: the port of
``paddle_tpu/serving/swap.py``'s ``publish_model_version`` and
``clear_model_version``.

The hot model swap itself (``SwapController``: gate, standby warm boot,
canary, cutover, watchdog, rollback, and the watch-dir deploy mode) is not
ported yet (ROADMAP queue 1 item 8): ``InferenceServer.swap`` and
``watch_dir`` raise.
"""

import threading

from paddle_tpu_torch.monitor.registry import gauge

__all__ = ["publish_model_version", "clear_model_version"]

_m_version = gauge(
    "serving_model_version",
    "1 for the model version the server is serving (label: the "
    "manifest's model_version, or 'unversioned')",
    labels=("version",))
_version_lock = threading.Lock()
_current_version_label = None


def publish_model_version(version):
    """Point the ``serving_model_version`` gauge at ``version`` (None ->
    'unversioned'), removing the superseded series. Process-global, like
    every serving gauge."""
    global _current_version_label
    label = version or "unversioned"
    with _version_lock:
        prev = _current_version_label
        _m_version.set(1, version=label)
        if prev is not None and prev != label:
            _m_version.remove(version=prev)
        _current_version_label = label


def clear_model_version(version):
    """Server close: drop the version series (a closed server serves
    nothing)."""
    global _current_version_label
    label = version or "unversioned"
    with _version_lock:
        _m_version.remove(version=label)
        if _current_version_label == label:
            _current_version_label = None
