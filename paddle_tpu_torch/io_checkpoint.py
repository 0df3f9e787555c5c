"""Async sharded checkpoint/resume for training loops: the port of
``paddle_tpu/io_checkpoint.py``.

The files are the JAX package's, key for key: one ``.npz`` shard per
host (``ckpt_<step>.shard<proc>.npz``) whose ``__manifest__`` member is
the tree manifest of ``static/serialize.py`` plus ``proc``/``nproc``,
``array_info``, the optional ``data_state`` cursor and the integrity
block (per-array CRC32, a digest over the sorted entries and a CRC of the
manifest body), and host 0's meta ``ckpt_<step>.json``. A checkpoint
written by either package restores in the other, and the JAX
``tools/fsck_checkpoint.py`` reads the port's directories.

- ``CheckpointManager``: step-tagged atomic checkpoints (mkstemp temp,
  fsync, ``os.replace``, directory fsync), a background writer thread so
  the step loop never waits on disk, per-host shards, ``keep_max``
  pruning, ``restore()`` with verification, quarantine (``*.corrupt``)
  and walk-back to the newest step that verifies; a transient ``OSError``
  is retried and re-raised, never taken for corruption; stale temps of a
  killed writer are swept when a manager starts; under ``nproc > 1`` on
  a shared directory ``restore(step=None)`` is a collective (host 0's
  round file, per-host verdicts, host 0's nonce-echoed decision); a step
  written by another world size is re-sliced (``array_info``,
  ``np.array_split`` extents) and its per-rank data cursors merged
  through ``dataio.dataloader.merge_rank_states``.
- ``auto_checkpoint``: a training loop that resumes from the newest
  verified step, saves every interval, and on SIGTERM saves the step it
  finished, drains the writer and exits 143.

What differs from the JAX package, because the port's state is torch
tensors that its optimizers update IN PLACE (``fused_adam`` and
``apply_gradients`` return the same tensors):

- ``save(step, tree)`` must hold step ``step``'s values while step
  ``step + 1`` already runs. A CPU tensor's ``.numpy()`` shares its
  memory, so CPU leaves and numpy leaves are copied before ``save``
  returns. Card leaves of one (device, dtype) are gathered by one
  ``torch.cat`` on the current stream into a device buffer (stream order
  puts it before the next step's update), copied on a side stream of the
  manager into a pinned host buffer, and an event is recorded there; the
  writer thread waits on that event before it reads. The step loop blocks
  only for the enqueue; the next update waits for nothing. Pinned buffers
  are pooled and reused once the writer has published a save.
- ``restore(..., device=None)`` and ``auto_checkpoint(..., device=None)``
  put the restored tensors on ``device``: the card unless the caller
  asks for the CPU (``paddle_tpu_torch.resolve_device``).
- A bfloat16 leaf raises ``ValueError`` naming the leaf. numpy has no
  bfloat16, and the JAX manager refuses such a leaf too (its CRC pass
  raises ``ValueError``).
- The host tag reads ``torch.distributed`` when it is initialized, else
  (0, 1); an explicit ``proc``/``nproc`` wins.

Nothing is pickled: a checkpoint is never code.
"""

import json
import logging
import os
import queue
import re
import signal
import tempfile
import threading
import time
import zlib

import numpy as np
import torch

from paddle_tpu_torch import resolve_device
from paddle_tpu_torch.core.enforce import EnforceNotMet, enforce
from paddle_tpu_torch.core.tree import map_tensors
from paddle_tpu_torch.monitor import goodput as _goodput
from paddle_tpu_torch.monitor.registry import counter as _counter
from paddle_tpu_torch.monitor.registry import histogram as _histogram
from paddle_tpu_torch.static.serialize import tree_from_manifest, tree_manifest

__all__ = ["CheckpointManager", "CheckpointCorruptError",
           "CheckpointTopologyError", "auto_checkpoint", "verify_shard",
           "even_interval", "publish_npz", "verify_npz", "SHARD_NAME_RE",
           "META_NAME_RE"]

_log = logging.getLogger("paddle_tpu.checkpoint")

#: the on-disk filename grammar, in ONE place — testing/faults and
#: tools/fsck_checkpoint parse the same names _shard_path/_meta_path
#: write, and a format change must not silently strand them
SHARD_NAME_RE = re.compile(r"^ckpt_(\d+)\.shard(\d+)\.npz$")
META_NAME_RE = re.compile(r"^ckpt_(\d+)\.json$")

#: multi-host restore coordination files (shared checkpoint dir):
#: host 0's round announcement, per-host round-tagged verdicts, and
#: host 0's nonce-echoed decision
_ROUND_NAME = ".restore.round.json"
_DECISION_NAME = ".restore.decision.json"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint shard (or its meta) failed integrity verification:
    unreadable file, CRC mismatch, missing/extra array, or digest
    drift. The message names the file and the first bad array."""


class CheckpointTopologyError(RuntimeError):
    """A checkpoint step cannot be restored onto this world size: it
    was written by a different ``nproc`` and the reshard plan cannot
    cover it (pre-``array_info`` shards, diverging tree structures
    across writers, or un-mergeable per-rank data cursors). The
    message names the written and reading ``nproc`` and the recovery
    move (restart at the written size, or re-save). Deliberately NOT a
    ``CheckpointCorruptError``: the files are healthy, so restore must
    never quarantine them over this."""


_m_saves = _counter("checkpoint_saves_total",
                    "Checkpoints made durable (shard written, retries "
                    "resolved)")
_m_save_ms = _histogram("checkpoint_save_ms",
                        "Wall ms to make one checkpoint durable "
                        "(serialize + write + atomic publish)")
_m_bytes = _counter("checkpoint_bytes_total",
                    "Array bytes snapshotted into checkpoints "
                    "(device->host copies at save())")
_m_retries = _counter("checkpoint_retries_total",
                      "Transient-disk-error retries of checkpoint "
                      "shard writes")
_m_corrupt = _counter("corrupt_checkpoints_total",
                      "Checkpoint steps quarantined after failing "
                      "integrity verification (shard/meta renamed "
                      "*.corrupt, restore fell back)")
_m_verify_fail = _counter("checkpoint_verify_failures_total",
                          "Individual shard integrity-verification "
                          "failures: unreadable file, CRC mismatch, "
                          "missing array, or digest drift")
_m_reshard = _counter("reshard_restores_total",
                      "Checkpoint restores that re-sliced writer "
                      "shards onto a different world size (counted "
                      "once per reading rank per restore)")


def _crc32(arr):
    """CRC32 of an array's canonical (C-contiguous) byte image."""
    a = np.ascontiguousarray(arr)
    if a.size == 0:
        # a zero-size array (e.g. an empty sparse-table snapshot)
        # can't cast its memoryview (a 0 in the shape); its byte
        # image is empty
        return zlib.crc32(b"") & 0xFFFFFFFF
    return zlib.crc32(memoryview(a).cast("B")) & 0xFFFFFFFF


def _canon_json(obj):
    return json.dumps(obj, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")


def _integrity_block(body, arrays):
    """The self-check record embedded in a shard manifest: per-array
    CRC32s, a whole-shard digest over the sorted (key, crc, nbytes)
    entries (catches a missing or extra array even when every present
    one checks out), and a CRC of the rest of the manifest itself
    (``body`` — the tree structure and data_state aren't covered by
    the array CRCs)."""
    entries = {k: {"crc32": _crc32(a), "nbytes": int(a.nbytes)}
               for k, a in arrays.items()}
    return {
        "algo": "crc32",
        "arrays": entries,
        "digest": zlib.crc32(_canon_json(entries)) & 0xFFFFFFFF,
        "manifest_crc32": zlib.crc32(_canon_json(body)) & 0xFFFFFFFF,
    }


def _key_paths(manifest):
    """npz key -> human tree path (e.g. 'a3' -> '/params/m/w0'), for
    naming the first bad array in errors. Best-effort: a malformed
    tree yields {} rather than masking the real corruption report."""
    out = {}

    def rec(node, path):
        if not isinstance(node, dict):
            return
        if "__d__" in node:
            for k, v in node["__d__"].items():
                rec(v, f"{path}/{k}")
        elif "__l__" in node or "__t__" in node:
            for i, v in enumerate(node.get("__l__") or node.get("__t__")):
                rec(v, f"{path}[{i}]")
        elif "__array__" in node:
            out[node["__array__"]] = path or "/"

    try:
        rec(manifest.get("tree", {}), "")
    except Exception:
        return {}
    return out


def _natural_key(k):
    return (len(k), k)       # a0, a1, ... a10 in numeric order


def even_interval(total, parts, idx):
    """The half-open interval ``[start, end)`` part ``idx`` of ``parts``
    owns when ``total`` elements are split as evenly as possible
    (``np.array_split`` convention: the first ``total % parts`` parts
    get one extra element). THE partition convention of the reshard
    planner and the data-parallel batch slicer — both sides computing
    it independently is what lets a reader derive its slice without
    any cross-host negotiation."""
    base, rem = divmod(int(total), int(parts))
    start = idx * base + min(idx, rem)
    return start, start + base + (1 if idx < rem else 0)


def _axes_map(manifest, axes):
    """{npz key: shard axis or None} from an ``axes`` pytree congruent
    to the saved tree (``None`` anywhere = that whole subtree is
    replicated). Walks the manifest's tree structure so the key
    assignment can never drift from ``tree_manifest``'s."""
    out = {}

    def rec(node, ax, path):
        if "__d__" in node:
            for k, v in node["__d__"].items():
                sub = None
                if ax is not None:
                    try:
                        sub = ax[k]
                    except (KeyError, TypeError, IndexError):
                        raise ValueError(
                            f"axes tree does not match the state tree "
                            f"at {path or '/'}: no entry for key {k!r}")
                rec(v, sub, f"{path}/{k}")
        elif "__l__" in node or "__t__" in node:
            seq = node.get("__l__")
            if seq is None:
                seq = node.get("__t__")
            for i, v in enumerate(seq):
                sub = None
                if ax is not None:
                    try:
                        sub = ax[i]
                    except (KeyError, TypeError, IndexError):
                        raise ValueError(
                            f"axes tree does not match the state tree "
                            f"at {path}[{i}]")
                rec(v, sub, f"{path}[{i}]")
        elif "__array__" in node:
            if ax is not None and (isinstance(ax, bool)
                                   or not isinstance(ax, int)):
                raise ValueError(
                    f"axes leaf at {path or '/'} must be None "
                    f"(replicated) or an int shard axis, got {ax!r}")
            out[node["__array__"]] = ax
        # "__leaf__" (inline scalar): nothing to shard

    rec(manifest["tree"], axes, "")
    return out


def _retry_transient(fn, what, retries=2, delay=0.05):
    """Run ``fn()``, retrying a transient ``OSError`` with doubling
    backoff and then re-raising it unchanged — the single home of the
    blip-is-not-corruption rule (shared by ``verify_shard``,
    ``_step_complete`` and ``tools/fsck_checkpoint``).
    ``FileNotFoundError`` is never transient (callers own existence
    checks), and every other exception propagates immediately:
    classifying content damage as corruption is the caller's job."""
    for attempt in range(retries + 1):
        try:
            return fn()
        except FileNotFoundError:
            raise
        except OSError as e:
            if attempt == retries:
                raise
            _log.warning("%s failed (%s: %s); retry %d/%d in %.2fs",
                         what, type(e).__name__, e, attempt + 1,
                         retries, delay)
            time.sleep(delay)
            delay *= 2.0


def _stat_exists(path, retries=2, delay=0.05):
    """``os.path.exists`` with the blip-is-not-corruption rule:
    ``exists()`` swallows EVERY OSError into False, so a transient
    stat failure (EIO, ESTALE) would silently classify a present
    shard as missing. Here FileNotFoundError means False, any other
    OSError is retried and then raised."""

    def probe():
        try:
            os.stat(path)
            return True
        except FileNotFoundError:
            return False

    return _retry_transient(probe, f"checkpoint stat {path}",
                            retries=retries, delay=delay)


def verify_shard(path, verify=True, read_retries=2, retry_delay=0.05):
    """Read one checkpoint shard, verifying its integrity record.

    Returns ``(manifest, {npz key: np.ndarray})``. Raises
    ``CheckpointCorruptError`` naming ``path`` and the first bad array
    on positive corruption evidence: torn/bit-rotted zip content, CRC
    mismatch, missing/extra array, digest drift. A transient I/O error
    (``OSError`` — an NFS hiccup, EIO) is NOT corruption: the read is
    retried ``read_retries`` times with doubling backoff and then the
    ``OSError`` re-raises unchanged, so callers crash-and-retry (the
    supervisor's restart budget) instead of quarantining a checkpoint
    that is merely unreachable right now. Shards written before the
    integrity format (no ``integrity`` block in the manifest) are
    accepted structurally — old checkpoints stay restorable.
    ``verify=False`` skips the CRC pass (bench A/B; the structural
    parse still runs). Shared by ``CheckpointManager.restore`` and
    ``tools/fsck_checkpoint.py``."""

    def bad(detail):
        _m_verify_fail.inc()
        return CheckpointCorruptError(
            f"checkpoint shard {path}: {detail}")

    def read():
        with np.load(path, allow_pickle=False) as blob:
            if "__manifest__" not in blob.files:
                raise bad("no __manifest__ member (not a checkpoint "
                          "shard, or header torn)")
            manifest = json.loads(
                bytes(blob["__manifest__"].tobytes()).decode("utf-8"))
            arrays = {k: blob[k] for k in blob.files
                      if k != "__manifest__"}
        return manifest, arrays

    try:
        manifest, arrays = _retry_transient(
            read, f"checkpoint shard {path} read",
            retries=read_retries, delay=retry_delay)
    except (CheckpointCorruptError, OSError):
        raise               # corruption verdict / transient I-O resp.
    except Exception as e:  # zipfile.BadZipFile, EOFError,
        # ValueError (torn npy header), UnicodeDecodeError/JSON
        # errors — the file's CONTENT is wrong, not the disk
        raise bad(f"unreadable ({type(e).__name__}: {e})") from e
    if not verify:
        return manifest, arrays
    _check_integrity(manifest, arrays, bad)
    return manifest, arrays


def _check_integrity(manifest, arrays, bad):
    """The CRC/digest verification pass shared by ``verify_shard`` and
    ``verify_npz``: per-array CRC32s, the sorted-entry-table digest
    (missing/extra arrays), and the manifest-body CRC. ``bad(detail)``
    builds the caller's exception (naming its own artifact kind + path).
    A manifest without an ``integrity`` block (pre-integrity format)
    passes vacuously — old artifacts stay restorable."""
    integ = manifest.get("integrity")
    if integ is None:           # pre-integrity format: nothing to check
        return
    paths = _key_paths(manifest)

    def name(key):
        p = paths.get(key)
        return f"array {key!r} ({p})" if p else f"array {key!r}"

    expected = integ.get("arrays", {})
    for key in sorted(expected, key=_natural_key):
        if key not in arrays:
            raise bad(f"{name(key)} missing from shard")
        got = _crc32(arrays[key])
        want = expected[key]["crc32"]
        if got != want:
            raise bad(f"first bad {name(key)}: crc32 {got:#010x} != "
                      f"recorded {want:#010x}")
    extra = sorted(set(arrays) - set(expected), key=_natural_key)
    if extra:
        raise bad(f"unrecorded array(s) {extra} present in shard")
    digest = zlib.crc32(_canon_json(expected)) & 0xFFFFFFFF
    if digest != integ.get("digest"):
        raise bad(f"shard digest {digest:#010x} != recorded "
                  f"{integ.get('digest'):#010x}")
    body = {k: v for k, v in manifest.items() if k != "integrity"}
    mcrc = zlib.crc32(_canon_json(body)) & 0xFFFFFFFF
    if mcrc != integ.get("manifest_crc32"):
        raise bad(f"manifest crc32 {mcrc:#010x} != recorded "
                  f"{integ.get('manifest_crc32'):#010x} (tree "
                  f"structure or data_state bit-rotted)")


def _publish_json_atomic(path, obj, prefix):
    """fsync'd atomic JSON publish via an mkstemp temp in the target
    directory (``prefix`` names the temp recognizably for the init
    sweeps) — THE one home of the idiom, shared by
    ``CheckpointManager._publish_json`` and the pserver snapshot
    store's meta markers (the JAX package's ``distributed/ps.py``): the temp-name
    grammar the sweeps and fsck parse must not be able to drift
    between the two writers."""
    dirname = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=dirname, suffix=".json.tmp",
                               prefix=prefix)
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(obj, f)
            _fsync_file(f)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def publish_npz(path, arrays, body=None):
    """Publish ``arrays`` as an integrity-manifested npz at ``path``
    ATOMICALLY: per-array CRC32 + sorted-entry digest embedded as a
    ``__manifest__`` member (``body`` — a JSON-able dict — rides in the
    manifest, covered by ``manifest_crc32``), written to an mkstemp
    temp in the same directory, fsync'd, then ``os.replace``d into
    place with a directory fsync. A crash at ANY point leaves either
    the previous artifact or a recognizable ``.tmp.npz`` leftover —
    never a half-written file under the published name. The pserver
    checkpoint artifacts (the JAX package's ``distributed/ps.py``) publish
    through its copy of this function;
    ``verify_npz`` is the reading side."""
    dirname = os.path.dirname(path) or "."
    arrays = {k: _host_array(v, k) for k, v in arrays.items()}
    body = dict(body or {})
    manifest = dict(body, integrity=_integrity_block(body, arrays))
    mblob = np.frombuffer(json.dumps(manifest).encode("utf-8"),
                          dtype=np.uint8)
    fd, tmp = tempfile.mkstemp(
        dir=dirname, suffix=".tmp.npz",
        prefix=f".{os.path.basename(path)}.")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __manifest__=mblob, **arrays)
            _fsync_file(f)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(dirname)
    return path


def verify_npz(path, verify=True, read_retries=2, retry_delay=0.05):
    """Read one ``publish_npz`` artifact, verifying its integrity
    record. Returns ``(manifest, arrays)``; ``manifest`` is None for a
    LEGACY artifact (a raw ``np.savez`` file with no ``__manifest__``
    member — accepted structurally, restorable but not provable).
    Raises ``CheckpointCorruptError`` on positive corruption evidence
    (torn zip, CRC mismatch, missing/extra array, digest drift); a
    transient ``OSError`` is retried and then re-raised unchanged —
    the blip-is-not-corruption rule ``verify_shard`` follows. Shared
    by the pserver warm-boot restore and ``tools/fsck_checkpoint``."""

    def bad(detail):
        _m_verify_fail.inc()
        return CheckpointCorruptError(f"npz artifact {path}: {detail}")

    def read():
        with np.load(path, allow_pickle=False) as blob:
            manifest = None
            if "__manifest__" in blob.files:
                manifest = json.loads(
                    bytes(blob["__manifest__"].tobytes())
                    .decode("utf-8"))
            arrays = {k: blob[k] for k in blob.files
                      if k != "__manifest__"}
        return manifest, arrays

    try:
        manifest, arrays = _retry_transient(
            read, f"npz artifact {path} read",
            retries=read_retries, delay=retry_delay)
    except (CheckpointCorruptError, OSError):
        raise               # corruption verdict / transient I-O resp.
    except Exception as e:  # zipfile.BadZipFile, EOFError,
        # ValueError (torn npy header), UnicodeDecodeError/JSON
        # errors — the file's CONTENT is wrong, not the disk
        raise bad(f"unreadable ({type(e).__name__}: {e})") from e
    if verify and manifest is not None:
        _check_integrity(manifest, arrays, bad)
    return manifest, arrays


def _fsync_file(f):
    f.flush()
    os.fsync(f.fileno())


def _fsync_dir(dirname):
    """Make a just-published rename durable: fsync the directory entry.
    Best-effort — some filesystems refuse O_RDONLY dir fsync."""
    try:
        fd = os.open(dirname, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _host_tag():
    """(rank, world size) of an initialized ``torch.distributed`` process
    group, else (0, 1)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _cross_writer_blocker(manifests):
    """Why a complete set of writer-shard manifests cannot be re-sliced
    onto a different world size, or None when the reshard plan covers
    them. THE one home of the cross-writer fitness rules — shared by
    ``CheckpointManager._reshard_load`` (which raises
    ``CheckpointTopologyError`` on it) and ``tools/fsck_checkpoint``'s
    offline ``--nproc`` judgment, so a new rule can never make fsck's
    verdict drift from ``restore()``'s behavior:

    - every writer must agree on tree structure and array set;
    - an array annotated replicated (axis None) must actually BE
      replicated — identical shape/dtype/CRC on every writer (per-host
      state saved under the ``axes=None`` default must refuse, not
      silently collapse to one host's copy);
    - a sharded array's off-axis dims must tile across writers.

    ``manifests``: {proc: manifest} for proc 0..W-1, every one carrying
    ``array_info`` (callers handle the legacy no-``array_info`` case
    first)."""
    W = len(manifests)
    ref = manifests[0]
    info = ref.get("array_info") or {}
    for p in range(1, W):
        m = manifests[p]
        if (set(m.get("array_info") or {}) != set(info)
                or m.get("tree") != ref.get("tree")):
            return (f"writer shards 0 and {p} disagree on tree "
                    f"structure / array set — not slices of one "
                    f"data-parallel state")

    def sig(p, key):
        i = manifests[p]["array_info"][key]
        crc = ((manifests[p].get("integrity") or {})
               .get("arrays", {}).get(key, {}).get("crc32"))
        return tuple(i.get("shape", ())), i.get("dtype"), crc

    for key, inf in info.items():
        # every writer must have annotated the SAME shard axis: planning
        # from one writer's annotation while another saved a different
        # layout would make readers concat a full copy as if it were a
        # slice (or replicate a slice) — wrong, rank-dependent state
        ax_by_p = {p: manifests[p]["array_info"][key].get("axis")
                   for p in range(W)}
        if len(set(ax_by_p.values())) > 1:
            return (f"array {key!r}: writers disagree on its shard "
                    f"axis ({ax_by_p}) — the axes= annotation must be "
                    f"identical on every host")
        axis = inf.get("axis")
        if axis is None:
            diff = [p for p in range(W) if sig(p, key) != sig(0, key)]
            if diff:
                return (f"array {key!r} is annotated replicated but "
                        f"writer shard(s) {diff} hold different "
                        f"content than shard 0 — per-host state must "
                        f"be saved with a shard axis (or excluded), "
                        f"not the axes=None default; collapsing it to "
                        f"one host's copy would silently restore "
                        f"wrong state")
        else:
            dts = {manifests[p]["array_info"][key].get("dtype")
                   for p in range(W)}
            if len(dts) > 1:
                return (f"array {key!r}: writers disagree on dtype "
                        f"({sorted(dts, key=repr)})")
            shapes = [manifests[p]["array_info"][key].get("shape", ())
                      for p in range(W)]
            for p, shp in enumerate(shapes):
                if (len(shp) != len(shapes[0])
                        or any(i != axis and d != shapes[0][i]
                               for i, d in enumerate(shp))):
                    return (f"array {key!r}: writer shard {p}'s shape "
                            f"{list(shp)} does not tile shard 0's "
                            f"{list(shapes[0])} along axis {axis}")
    return None


def _refuse_bf16(dtype, where):
    if dtype == torch.bfloat16:
        raise ValueError(
            f"checkpoint leaf {where} is bfloat16, which numpy cannot "
            f"hold (the JAX manager refuses it too): cast it to float32 "
            f"or store its 16-bit lanes (tensor.view(torch.int16))")


def _host_array(v, where):
    """A leaf as a numpy array of its own (a copy: a CPU tensor's
    ``.numpy()`` shares its memory, and the caller may update it in place
    before the writer reads it)."""
    if isinstance(v, torch.Tensor):
        _refuse_bf16(v.dtype, where)
        return v.detach().cpu().numpy().copy()
    return np.array(v, copy=True)


class _Snapshot:
    """One save's arrays on the host, and what the writer waits for.

    Card tensors of one (device, dtype) are concatenated on the current
    stream into one device buffer, copied on the manager's side stream
    into one pinned host buffer (taken from ``pool``), and an event is
    recorded there; ``arrays`` are numpy views of the host buffers, valid
    once ``ready()`` returned. ``release()`` gives the buffers back to
    the pool after the write."""

    def __init__(self, leaves, paths, pool, streams):
        self.arrays, self._events, self._held = {}, [], []
        self._pool = pool
        groups = {}
        for k, v in leaves.items():
            where = paths.get(k, k)
            if isinstance(v, torch.Tensor) and v.device.type == "cuda":
                _refuse_bf16(v.dtype, where)
                groups.setdefault((v.device, v.dtype), []).append(k)
            else:
                self.arrays[k] = _host_array(v, where)
        for (device, dtype), keys in groups.items():
            ts = [leaves[k].detach() for k in keys]
            flat = torch.cat([t.reshape(-1) for t in ts])
            host = pool.take(dtype, flat.numel())
            side = streams.get(device)
            if side is None:
                side = streams[device] = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                host.copy_(flat, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(side)
            flat.record_stream(side)
            self._events.append(ev)
            self._held.append(host)
            view, off = host.numpy(), 0
            for k, t in zip(keys, ts):
                self.arrays[k] = view[off:off + t.numel()].reshape(
                    tuple(t.shape))
                off += t.numel()

    def ready(self):
        for ev in self._events:
            ev.synchronize()
        self._events = []

    def release(self):
        self.ready()
        self.arrays = {}
        for host in self._held:
            self._pool.give(host)
        self._held = []


class _PinnedPool:
    """Pinned host buffers by (dtype, numel), reused across saves; a save
    that finds none free allocates one (so a writer that lags its
    interval costs host memory, as the JAX manager's queue does)."""

    def __init__(self):
        self._free = {}
        self._lock = threading.Lock()

    def take(self, dtype, n):
        with self._lock:
            free = self._free.get((dtype, n))
            if free:
                return free.pop()
        return torch.empty(n, dtype=dtype, pin_memory=True)

    def give(self, buf):
        with self._lock:
            self._free.setdefault((buf.dtype, buf.numel()), []).append(buf)

    def clear(self):
        with self._lock:
            self._free = {}


class _PendingMerge:
    """Per-writer data cursors a resharded restore stashed for
    ``restore_data_state`` to merge LAZILY: a job that never wired a
    ``data_state`` must not fail its model restore over un-mergeable
    cursors (and must not pay the merge)."""

    def __init__(self, states):
        self.states = states


class CheckpointManager:
    """Step-tagged async checkpoints in ``dirname``.

    save(step, tree, data_state=None)
                                -> enqueue (device->host copy now, disk
                                   write in background)
    wait()                      -> block until writes are durable
    latest_step()               -> newest complete step (meta present
                                   AND every saved shard present) or
                                   None — not necessarily verified
    restore(step=None)          -> (tree, step); step=None verifies and
                                   falls back past corrupt steps,
                                   quarantining them; an explicit step
                                   raises CheckpointCorruptError
    restore_data_state(step)    -> the data-pipeline cursor saved with
                                   that step (None if none was saved)
    should_save(step)           -> interval policy check
    """

    #: transient disk-error policy: a failed shard write is retried
    #: ``disk_retries`` times with doubling backoff (capped) before the
    #: error is surfaced on the next save()/wait() — an NFS blip or
    #: ENOSPC race must not silently cost a checkpoint interval
    disk_retries = 3
    retry_backoff = 0.1
    retry_backoff_cap = 2.0
    #: multi-host restore coordination: how long each host waits for
    #: peer verdicts / host 0's decision before giving up (RuntimeError
    #: -> the supervisor's restart budget, never a silent divergence)
    coord_timeout = 120.0

    def __init__(self, dirname, keep_max=3, save_interval_steps=100,
                 save_interval_secs=None, async_save=True,
                 disk_retries=None, verify_restore=True, proc=None,
                 nproc=None):
        self.dirname = dirname
        self.keep_max = keep_max
        if disk_retries is not None:
            self.disk_retries = disk_retries
        self.save_interval_steps = save_interval_steps
        self.save_interval_secs = save_interval_secs
        #: default for restore(verify=): CRC-check shards on load
        self.verify_restore = verify_restore
        self._last_save_time = time.monotonic()
        os.makedirs(dirname, exist_ok=True)
        # explicit proc/nproc override the torch.distributed host tag:
        # under an elastic supervisor the incarnation's world size is
        # launcher metadata (PADDLE_TRAINER_ID / PADDLE_TRAINERS_NUM),
        # not something an uninitialized process can see — and it is the
        # reading-vs-written nproc comparison that triggers resharding
        tag = _host_tag()
        self._proc = tag[0] if proc is None else int(proc)
        self._nproc = tag[1] if nproc is None else int(nproc)
        #: newest step this manager has verified on READ (a restore
        #: that checked out) — _prune never deletes it. Writes are not
        #: "verified": fsync'd+CRC'd at write time, but disk rot after
        #: the fact is exactly what verification exists to catch.
        self._last_verified = None
        self._restored_data_state = None        # (step, state) cache
        self._sweep_stale_tmps()
        self._q = queue.Queue()
        self._pool = _PinnedPool()
        self._streams = {}
        self._err = None
        self._thread = None
        if async_save:
            self._thread = threading.Thread(target=self._writer,
                                            daemon=True)
            self._thread.start()

    def _sweep_stale_tmps(self):
        """Remove write temps and coordination leftovers a killed
        previous incarnation left behind. Scoped to THIS host's shard
        temps, its own restore verdict, and its own verdict temps
        (``.restore.v<P>.*`` — host-tagged precisely so no other host
        can mistake them for its own); host 0 additionally sweeps meta
        temps (mkstemp ``.ckpt_N.meta.*.json.tmp`` plus the legacy
        fixed ``ckpt_N.json.tmp`` name no current writer uses), its
        round/decision temps (``.restore.r.*`` / ``.restore.d.*``),
        and the round + decision files. Another live host's in-flight
        temp is never yanked out from under its writer — a peer may
        be mid-``_publish_json`` of its verdict while this host
        inits; the supervisor guarantees the previous incarnation of
        THIS host is dead before a restart, so same-host temps are
        stale by construction."""
        tag = f".shard{self._proc}."
        verdict = os.path.basename(self._verdict_path(self._proc))
        vtmp = f".restore.v{self._proc}."
        for f in os.listdir(self.dirname):
            mine = ((f.endswith(".tmp.npz") and tag in f)
                    or f == verdict
                    or (f.endswith(".json.tmp") and f.startswith(vtmp)))
            if self._proc == 0:
                mine = mine or (f.endswith(".json.tmp") and
                                (f.startswith(".ckpt_") or
                                 f.startswith(".restore.r.") or
                                 f.startswith(".restore.d.") or
                                 f.startswith("ckpt_")))
                mine = mine or f in (_ROUND_NAME, _DECISION_NAME)
            if not mine:
                continue
            try:
                os.remove(os.path.join(self.dirname, f))
                _log.info("swept stale checkpoint temp %s", f)
            except OSError:
                pass

    # -- paths -------------------------------------------------------------
    def _shard_path(self, step, proc=None):
        p = self._proc if proc is None else proc
        return os.path.join(self.dirname, f"ckpt_{step}.shard{p}.npz")

    def _meta_path(self, step):
        return os.path.join(self.dirname, f"ckpt_{step}.json")

    def _verdict_path(self, proc):
        return os.path.join(self.dirname, f".restore.h{proc}.json")

    def _round_path(self):
        return os.path.join(self.dirname, _ROUND_NAME)

    def _decision_path(self):
        return os.path.join(self.dirname, _DECISION_NAME)

    def _publish_json(self, path, obj, prefix):
        """fsync'd atomic JSON publish via an mkstemp temp in the
        checkpoint dir (``prefix`` names the temp recognizably for the
        init sweep)."""
        _publish_json_atomic(path, obj, prefix)

    # -- policy ------------------------------------------------------------
    def should_save(self, step):
        if self.save_interval_secs is not None:
            return (time.monotonic() - self._last_save_time
                    >= self.save_interval_secs)
        return step % max(self.save_interval_steps, 1) == 0

    # -- save --------------------------------------------------------------
    def save(self, step, tree, data_state=None, axes=None):
        """Snapshot now (device→host), write later. Returns immediately
        when async. ``data_state`` is an optional JSON-able input-
        pipeline cursor (``FileDataLoader.state()``) stored in the
        shard manifest (per-host, CRC-covered) and mirrored into the
        meta JSON for operator visibility.

        ``axes`` annotates how this host's tree tiles the job-level
        state: a pytree congruent to ``tree`` whose leaves are ``None``
        (replicated — every host saved an identical copy) or an int
        axis (this host saved its slice along that axis; the global
        array is the proc-ordered concatenation of all hosts' slices).
        The annotation, plus each array's shape/dtype, is recorded in
        the manifest (``array_info``) — it is what lets ``restore()``
        re-shard the step onto a different world size."""
        _t_gp = time.perf_counter() if _goodput._armed else None
        manifest, leaves = tree_manifest(tree, to_array=lambda x: x)
        snap = _Snapshot(leaves, _key_paths(manifest), self._pool,
                         self._streams)
        arrays = snap.arrays
        ax = _axes_map(manifest, axes)
        info = {}
        for k, a in arrays.items():
            axis = ax.get(k)
            if axis is not None and not 0 <= axis < a.ndim:
                raise ValueError(
                    f"save(axes=...): shard axis {axis} out of range "
                    f"for array of shape {tuple(a.shape)}")
            info[k] = {"shape": [int(d) for d in a.shape],
                       "dtype": str(a.dtype.name), "axis": axis}
        manifest["array_info"] = info
        _m_bytes.inc(sum(a.nbytes for a in arrays.values()))
        payload = (int(step), manifest, snap, data_state)
        self._last_save_time = time.monotonic()
        if self._thread is None:
            try:
                self._write_durable(payload)
            finally:
                snap.release()
        else:
            self._raise_pending()
            self._q.put(payload)
        if _t_gp is not None:
            # goodput ledger: the step loop was blocked for the d2h
            # snapshot + enqueue (or the full durable write when sync)
            _goodput.attribute(time.perf_counter() - _t_gp,
                               phase="checkpoint_save")

    def maybe_save(self, step, tree, data_state=None, axes=None):
        if self.should_save(step):
            self.save(step, tree, data_state=data_state, axes=axes)
            return True
        return False

    def _write_durable(self, payload):
        """_write with capped-backoff retry on transient disk errors
        (OSError only: the peer-shard timeout RuntimeError is not a
        disk fault and is never retried)."""
        delay = self.retry_backoff
        t0 = time.perf_counter()
        for attempt in range(self.disk_retries + 1):
            try:
                out = self._write(payload)
                _m_saves.inc()
                _m_save_ms.observe((time.perf_counter() - t0) * 1e3)
                return out
            except OSError as e:
                if attempt == self.disk_retries:
                    raise
                _m_retries.inc()
                _log.warning(
                    "checkpoint step %s write failed (%s: %s); retry "
                    "%d/%d in %.2fs", payload[0], type(e).__name__, e,
                    attempt + 1, self.disk_retries, delay)
                time.sleep(delay)
                delay = min(delay * 2.0, self.retry_backoff_cap)

    def _write(self, payload):
        step, manifest, snap, data_state = payload
        snap.ready()
        arrays = snap.arrays
        shard = self._shard_path(step)
        body = dict(manifest, proc=self._proc, nproc=self._nproc)
        if data_state is not None:
            body["data_state"] = data_state
        manifest = dict(body,
                        integrity=_integrity_block(body, arrays))
        mblob = np.frombuffer(
            json.dumps(manifest).encode("utf-8"), dtype=np.uint8)
        # mkstemp (not a fixed name): two incarnations racing on the
        # same step can't interleave writes into one temp, and a
        # killed writer's leftover is unambiguous to sweep on init
        fd, tmp = tempfile.mkstemp(
            dir=self.dirname, suffix=".tmp.npz",
            prefix=f".ckpt_{step}.shard{self._proc}.")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, __manifest__=mblob, **arrays)
                # fsync BEFORE the rename: os.replace orders the
                # directory entry, not the data pages — unsynced
                # pages + a host crash can leave the published name
                # pointing at torn content
                _fsync_file(f)
            os.replace(tmp, shard)                # atomic publish
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise
        _fsync_dir(self.dirname)
        # host 0 publishes the meta marker only after EVERY host's shard
        # is durable (restore trusts only steps whose meta exists, so a
        # preemption mid-save can never yield a half-checkpoint)
        if self._proc == 0:
            deadline = time.monotonic() + 120.0
            while any(not os.path.exists(self._shard_path(step, p))
                      for p in range(self._nproc)):
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"checkpoint step {step}: peer shards missing "
                        f"after 120s; not publishing meta")
                time.sleep(0.05)
            meta = {"step": step, "nproc": self._nproc,
                    "time": time.time()}
            if data_state is not None:
                meta["data_state"] = data_state
            # mkstemp like the shards: a fixed temp name would let two
            # incarnations racing on the same step interleave writes
            # into one file
            self._publish_json(self._meta_path(step), meta,
                               prefix=f".ckpt_{step}.meta.")
            _fsync_dir(self.dirname)
        self._prune()

    def _writer(self):
        while True:
            payload = self._q.get()
            if payload is None:
                return
            if isinstance(payload, threading.Event):
                payload.set()               # wait() barrier
                continue
            try:
                self._write_durable(payload)
            except Exception as e:          # surfaced on next save/wait
                self._err = e
            finally:
                payload[2].release()

    def _raise_pending(self):
        if self._err is not None:
            e, self._err = self._err, None
            raise e

    def wait(self, timeout=60.0):
        """Block until every enqueued checkpoint is durable."""
        if self._thread is not None and self._thread.is_alive():
            done = threading.Event()
            self._q.put(done)
            _t_gp = time.perf_counter() if _goodput._armed else None
            ok = done.wait(timeout)
            if _t_gp is not None:
                _goodput.attribute(time.perf_counter() - _t_gp,
                                   phase="checkpoint_save")
            enforce(ok, "checkpoint writer stalled")
        self._raise_pending()

    def _prune(self):
        """keep_max newest complete steps survive — plus the newest
        step this manager VERIFIED on read. Quarantined (.corrupt) and
        incomplete (meta-without-shard) steps never count against
        keep_max: a quarantine must not silently shrink the budget of
        restorable history below keep_max good steps."""
        if not self.keep_max:
            return
        steps = self._complete_steps()
        keep = set(steps[-self.keep_max:])
        if self._last_verified is not None:
            keep.add(self._last_verified)
        drop = [s for s in steps if s not in keep]
        if not drop:
            return
        # scan-based like _quarantine, not range(self._nproc): after an
        # elastic shrink this incarnation's nproc is SMALLER than the
        # one that wrote the old steps, and pruning only our own shard
        # indices would leak the higher-numbered peers' shards forever
        try:
            names = os.listdir(self.dirname)
        except OSError:
            names = []
        for s in drop:
            for f in names:
                m = SHARD_NAME_RE.match(f)
                if m and int(m.group(1)) == s:
                    try:
                        os.remove(os.path.join(self.dirname, f))
                    except FileNotFoundError:
                        pass
            try:
                os.remove(self._meta_path(s))
            except FileNotFoundError:
                pass

    # -- restore -----------------------------------------------------------
    def _meta_steps(self):
        steps = []
        for f in os.listdir(self.dirname):
            if f.startswith("ckpt_") and f.endswith(".json"):
                try:
                    steps.append(int(f[len("ckpt_"):-len(".json")]))
                except ValueError:
                    pass
        return sorted(steps)

    def _step_complete(self, step, read_retries=2, retry_delay=0.05):
        """Meta readable AND every shard it promises present. A stray
        or torn ckpt_N.json (shards pruned by hand, meta half-written
        by a dying host) must not be offered for restore. A transient
        I/O error reading the meta is NOT incompleteness: silently
        returning False would drop the newest good step from
        _complete_steps and restore an older one with no fallback
        warning — so, like verify_shard, the read is retried and then
        the OSError re-raises (crash-and-retry via the supervisor, or
        _write_durable's retry loop when called from _prune)."""
        def read_nproc():
            try:
                with open(self._meta_path(step)) as f:
                    return int(json.load(f).get("nproc", 1))
            except FileNotFoundError:
                return None
            except (ValueError, TypeError):
                return None     # torn/garbage content, not a blip

        nproc = _retry_transient(
            read_nproc, f"checkpoint meta for step {step} read",
            retries=read_retries, delay=retry_delay)
        if nproc is None:
            return False
        # _stat_exists, not os.path.exists: exists() swallows a stat
        # blip into "missing", silently dropping the newest good step
        return all(_stat_exists(self._shard_path(step, p),
                                retries=read_retries,
                                delay=retry_delay)
                   for p in range(nproc))

    def _complete_steps(self):
        return [s for s in self._meta_steps() if self._step_complete(s)]

    def latest_step(self):
        """Newest complete step or None. Complete = meta readable and
        all its shards on disk; NOT necessarily verified — restore()
        is where CRCs are checked (and where fallback happens)."""
        steps = self._complete_steps()
        return steps[-1] if steps else None

    def _quarantine(self, step, err):
        """Move a corrupt step out of the restore path, keeping the
        evidence: EVERY host's shard -> *.corrupt (an un-renamed peer
        shard would leak forever once the meta is gone — no meta means
        the step never reaches _complete_steps, so _prune never
        collects it) plus meta -> *.corrupt. Counted in
        corrupt_checkpoints_total and noted in the flight recorder."""
        _m_corrupt.inc()
        _log.warning("checkpoint step %s quarantined: %s (renaming "
                     "shards/meta to *.corrupt)", step, err)
        targets = [os.path.basename(self._meta_path(step))]
        try:
            for f in os.listdir(self.dirname):
                m = SHARD_NAME_RE.match(f)
                if m and int(m.group(1)) == step:
                    targets.append(f)
        except OSError:
            targets.append(os.path.basename(self._shard_path(step)))
        renamed = []
        for f in targets:
            path = os.path.join(self.dirname, f)
            try:
                os.replace(path, path + ".corrupt")
                renamed.append(f + ".corrupt")
            except OSError:
                pass
        try:
            from paddle_tpu_torch.monitor import flight_recorder
            flight_recorder.note("checkpoint", "quarantined", step=step,
                                 error=str(err), renamed=renamed)
        except Exception:
            pass

    def _saved_nproc(self, step):
        """The world size that wrote ``step`` (its meta's ``nproc``),
        retry-reading transient blips. FileNotFoundError propagates
        (the step vanished — callers own that); torn/garbage content
        raises CheckpointCorruptError like every other meta read."""
        meta_path = self._meta_path(step)

        def read():
            with open(meta_path) as f:
                return int(json.load(f).get("nproc", 1))

        try:
            return _retry_transient(
                read, f"checkpoint meta {meta_path} read")
        except (ValueError, TypeError) as e:
            _m_verify_fail.inc()
            raise CheckpointCorruptError(
                f"checkpoint meta {meta_path} unreadable "
                f"({type(e).__name__}: {e})") from e

    def _read_own_shard(self, step, verify, saved_nproc=None):
        """(manifest, arrays) for this host's shard of one step,
        CRC-verified. Raises CheckpointCorruptError on positive
        corruption evidence (torn meta JSON, bad shard content);
        transient OSErrors propagate unchanged (see verify_shard)."""
        if saved_nproc is None:
            try:
                saved_nproc = self._saved_nproc(step)
            except FileNotFoundError:
                enforce(False, f"no checkpoint meta for step {step} in "
                               f"{self.dirname}")
        path = self._shard_path(step)
        if not os.path.exists(path):
            enforce(saved_nproc == 1,
                    f"checkpoint step {step} was saved by {saved_nproc} "
                    f"hosts but shard for host {self._proc} is missing — "
                    f"restoring another host's shard would load wrong "
                    f"parameter data")
            # replicated (single-host) checkpoint restored on a larger
            # topology: every host reads the one shard
            path = self._shard_path(step, 0)
        return verify_shard(path, verify=verify)

    @staticmethod
    def _tree_of(manifest, arrays):
        """The tree with CPU tensors over the read arrays (no copy);
        ``restore`` moves it to its device once the step is agreed."""
        return tree_from_manifest(manifest, arrays)

    # -- resharding: restore onto a different world size --------------------
    def _read_shard_manifest(self, path):
        """Manifest-only read of one shard (parse + manifest_crc32
        check, no array loads or CRCs) — the reshard planner reads all
        W of these before deciding which shards to actually load.
        Corrupt content raises CheckpointCorruptError; transient
        OSErrors are retried then re-raised (blip-is-not-corruption)."""

        def bad(detail):
            _m_verify_fail.inc()
            return CheckpointCorruptError(
                f"checkpoint shard {path}: {detail}")

        def read():
            with np.load(path, allow_pickle=False) as blob:
                if "__manifest__" not in blob.files:
                    raise bad("no __manifest__ member (not a "
                              "checkpoint shard, or header torn)")
                return json.loads(
                    bytes(blob["__manifest__"].tobytes()).decode("utf-8"))

        try:
            manifest = _retry_transient(
                read, f"checkpoint shard {path} manifest read")
        except (CheckpointCorruptError, OSError):
            raise
        except Exception as e:
            raise bad(f"unreadable ({type(e).__name__}: {e})") from e
        integ = manifest.get("integrity")
        if integ is not None:
            body = {k: v for k, v in manifest.items() if k != "integrity"}
            mcrc = zlib.crc32(_canon_json(body)) & 0xFFFFFFFF
            if mcrc != integ.get("manifest_crc32"):
                raise bad(f"manifest crc32 {mcrc:#010x} != recorded "
                          f"{integ.get('manifest_crc32'):#010x}")
        return manifest

    def _topo_error(self, step, written, detail):
        return CheckpointTopologyError(
            f"checkpoint step {step} in {self.dirname} was written by "
            f"nproc={written} host(s) but is being read by "
            f"nproc={self._nproc}: {detail}")

    def _reshard_load(self, step, verify, saved_nproc=None):
        """Restore one step written by a DIFFERENT world size: plan a
        per-array re-slice from the W writer manifests, read (and fully
        CRC-verify) exactly the writer shards this reader needs, and
        re-materialize this host's slice of the state.

        Returns ``(tree, reference manifest, [data_state per writer])``.
        Raises CheckpointCorruptError on any touched shard failing
        verification (the caller's quarantine/walk-back applies) and
        CheckpointTopologyError when the plan cannot cover the step
        (legacy shards without ``array_info``, diverging trees)."""
        W = saved_nproc if saved_nproc is not None else \
            self._saved_nproc(step)
        R, r = self._nproc, self._proc
        manifests = {p: self._read_shard_manifest(self._shard_path(step, p))
                     for p in range(W)}
        infos = {p: m.get("array_info") for p, m in manifests.items()}
        legacy = sorted(p for p, i in infos.items() if i is None)
        if legacy:
            if W == 1:
                # pre-reshard single-host save: the replicated fallback
                # (every host reads the whole shard) — today's path
                manifest, arrays = verify_shard(
                    self._shard_path(step, 0), verify=verify)
                return (self._tree_of(manifest, arrays), manifest,
                        [manifest.get("data_state")])
            raise self._topo_error(
                step, W,
                f"writer shard(s) {legacy} predate the reshard "
                f"metadata (no array_info in the manifest), so the "
                f"re-slice plan cannot cover them — restart at the "
                f"written world size (check `fsck_checkpoint.py "
                f"--nproc`), or re-save the checkpoint")
        why = _cross_writer_blocker(manifests)
        if why:
            raise self._topo_error(step, W, why)
        src = r % W                     # replicated-leaf source shard
        ref = manifests[src]
        plan, needed = {}, {src}
        for key, inf in infos[src].items():
            axis = inf.get("axis")
            if axis is None:
                plan[key] = None
                continue
            lens = [infos[p][key]["shape"][axis] for p in range(W)]
            start, end = even_interval(sum(lens), R, r)
            off, pieces = 0, []
            for p, ln in enumerate(lens):
                lo, hi = max(start - off, 0), min(end - off, ln)
                if lo < hi:
                    pieces.append((p, lo, hi))
                    needed.add(p)
                off += ln
            plan[key] = (axis, pieces)
        arrays_by_p = {
            p: verify_shard(self._shard_path(step, p), verify=verify)[1]
            for p in sorted(needed)}
        out = {}
        for key, pl in plan.items():
            if pl is None:
                out[key] = arrays_by_p[src][key]
                continue
            axis, pieces = pl
            if not pieces:
                # this reader's interval is empty (more readers than
                # rows): a zero-length slice with the right dtype and
                # trailing dims
                a = arrays_by_p[src][key]
                idx = [slice(None)] * a.ndim
                idx[axis] = slice(0, 0)
                out[key] = a[tuple(idx)]
                continue
            slices = []
            for p, lo, hi in pieces:
                a = arrays_by_p[p][key]
                idx = [slice(None)] * a.ndim
                idx[axis] = slice(lo, hi)
                slices.append(a[tuple(idx)])
            out[key] = slices[0] if len(slices) == 1 \
                else np.concatenate(slices, axis=axis)
        tree = self._tree_of(ref, out)
        # reshard_restores_total is bumped by the callers at restore
        # COMMIT time — the coordinated path may pre-load during
        # verification and reuse the result, which must count once
        _log.warning(
            "resharded checkpoint step %s: written nproc=%d -> read "
            "nproc=%d (host %d read writer shard(s) %s)",
            step, W, R, r, sorted(needed))
        return tree, ref, [manifests[p].get("data_state")
                           for p in range(W)]

    def _merge_data_states(self, step, states):
        """All W writers' data cursors -> one job-level frontier (the
        input-pipeline half of a topology change). None when no writer
        saved one; CheckpointTopologyError when they cannot be merged
        exactly — a rescale must never silently drop or double-consume
        records."""
        if all(s is None for s in states):
            return None
        if any(s is None for s in states):
            saved = [p for p, s in enumerate(states) if s is not None]
            raise self._topo_error(
                step, len(states),
                f"only writer shard(s) {saved} carry a data cursor — "
                f"a partial frontier cannot be re-partitioned exactly")
        from paddle_tpu_torch.dataio.dataloader import merge_rank_states
        try:
            return merge_rank_states(states)
        except ValueError as e:
            raise self._topo_error(
                step, len(states),
                f"the per-rank data cursors cannot be merged into a "
                f"job-level frontier ({e}); resume at the written "
                f"world size instead") from e

    def _load_step_any(self, step, verify):
        """(tree, manifest, data_state) honoring topology: a step
        written by this very world size takes the fast path (own
        shard, no manifest pre-scan — the fixed-world restore pays no
        reshard cost); any other written nproc goes through the
        reshard plan, whose data cursors merge into one frontier."""
        try:
            W = self._saved_nproc(step)
        except FileNotFoundError:
            enforce(False, f"no checkpoint meta for step {step} in "
                           f"{self.dirname}")
        if W == self._nproc:
            manifest, arrays = self._read_own_shard(step, verify,
                                                    saved_nproc=W)
            return (self._tree_of(manifest, arrays), manifest,
                    manifest.get("data_state"))
        tree, ref, dstates = self._reshard_load(step, verify,
                                                saved_nproc=W)
        _m_reshard.inc()
        return tree, ref, _PendingMerge(dstates)

    def restore(self, step=None, verify=None, device=None):
        """Returns (tree, step). Under multi-process, each host reads
        its own shard (the sharding that was saved) — unless the step
        was written by a *different* world size, in which case the
        reshard plan re-slices the writer shards onto this topology
        (see ``_reshard_load``; ``CheckpointTopologyError`` when the
        plan cannot cover the step, e.g. pre-``array_info`` shards).

        With ``step=None`` the newest *verifying* step is restored:
        corrupt/torn steps are quarantined (every host's shard + meta
        renamed ``*.corrupt``) and the walk continues backwards — the
        last-good fallback. Under multi-process with a shared
        checkpoint dir this is a COLLECTIVE: hosts exchange per-host
        verdict files and host 0 publishes the newest step EVERY host
        verified, so no two ranks can silently resume from different
        steps (one host's corrupt shard walks the whole gang back).
        An explicit ``step=`` that fails verification raises
        ``CheckpointCorruptError`` naming the file and first bad
        array. ``verify=False`` skips CRC checks (default: the
        manager's ``verify_restore``). The tensors go to ``device`` (the
        card unless the caller asks for the CPU)."""
        device = resolve_device(device)
        _t_gp = time.perf_counter() if _goodput._armed else None
        try:
            tree, got = self._restore_inner(step, verify)
            return map_tensors(lambda t: t.to(device), tree), got
        finally:
            if _t_gp is not None:
                # goodput ledger: restore stall (verification walk-back,
                # the multi-host coordination wait and the copy to the
                # device included)
                _goodput.attribute(time.perf_counter() - _t_gp,
                                   phase="checkpoint_restore")

    def _restore_inner(self, step=None, verify=None):
        if verify is None:
            verify = self.verify_restore
        if step is not None:
            tree, _manifest, ds = self._load_step_any(step, verify)
            if verify:
                self._last_verified = step
            self._restored_data_state = (step, ds)
            return tree, step
        if self._nproc > 1:
            return self._restore_coordinated(verify)
        steps = self._complete_steps()
        enforce(steps, f"no checkpoint in {self.dirname}")
        newest = steps[-1]
        quarantined = 0
        for s in reversed(steps):
            try:
                tree, _manifest, ds = self._load_step_any(s, verify)
            except CheckpointCorruptError as e:
                self._quarantine(s, e)
                quarantined += 1
                continue
            # CheckpointTopologyError propagates: the step is HEALTHY,
            # just written for another world size — silently walking
            # past it to older state would lose training progress with
            # no operator decision; the error names the recovery move
            if verify:
                self._last_verified = s
            self._restored_data_state = (s, ds)
            if s != newest:
                # the restart-from-fallback line (docs/DEBUGGING.md's
                # exit-code/recovery table points at it)
                _log.warning(
                    "restored from last-good checkpoint step %s after "
                    "quarantining %d corrupt newer step(s)",
                    s, quarantined)
            return tree, s
        raise CheckpointCorruptError(
            f"every checkpoint step in {self.dirname} failed "
            f"verification ({quarantined} quarantined); nothing left "
            f"to restore")

    # -- multi-host restore coordination ------------------------------------
    # restore(step=None) on a SHARED checkpoint dir must be a
    # collective: if host 1's shard of step N is rotted but host 0's
    # verifies, independent walk-backs would resume the ranks from
    # DIFFERENT steps — silent data-parallel corruption. Protocol:
    # host 0 announces a fresh ROUND (.restore.round.json: id + mode);
    # every host verifies its own shards per the round's mode and
    # publishes a verdict file tagged with that round id plus a fresh
    # nonce; host 0 accepts only current-round verdicts, picks the
    # newest step every host verified, quarantines positively-corrupt
    # steps, and publishes a decision echoing each host's nonce; a
    # host accepts only a decision that echoes the nonce it just
    # published, and while waiting re-checks the round file — a NEW
    # round id (host 0 died and restarted mid-protocol, or an
    # escalation) re-publishes the verdict under it.
    #
    # Two round modes keep the healthy path cheap: mode "first" (the
    # opening round) verifies newest-first and STOPS at the first good
    # step — one shard read+CRC per host per restart, not keep_max of
    # them — marking the verdict partial when older steps were left
    # unverified. When the partial ok-sets don't intersect (some
    # host's newest good step isn't everyone's), host 0 escalates
    # once to a mode "full" round under a fresh id: every host
    # verifies every step and republishes, and agreement proceeds as
    # before. The escalation costs one extra handshake only in the
    # already-rare corrupt-shard case.
    #
    # A stale verdict left by a dead incarnation carries a stale round
    # id, so host 0 never decides on it (the live peer republishes as
    # soon as it sees the fresh round — no repeatable timeout loop); a
    # stale decision fails the nonce echo. Worst case is timeout ->
    # RuntimeError -> supervisor gang restart, never a cross-host
    # divergence.

    def _await(self, poll, what, deadline_box=None):
        """Poll until ``poll()`` returns non-None or ``coord_timeout``
        elapses. ``deadline_box`` (a dict) lets the poll closure RESET
        the deadline on observed protocol progress — a follower that
        just saw a new round id is mid-handshake, not abandoned, and
        must get a full budget for the (possibly full-mode) verify
        pass that round demands; without the reset, first-pass time
        already spent would make a large-shard escalation a
        deterministic timeout -> gang-restart loop."""
        box = deadline_box if deadline_box is not None else {}
        box.setdefault("deadline", time.monotonic() + self.coord_timeout)
        while True:
            got = poll()
            if got is not None:
                return got
            if time.monotonic() > box["deadline"]:
                raise RuntimeError(
                    f"checkpoint restore coordination timed out after "
                    f"{self.coord_timeout}s waiting for {what} in "
                    f"{self.dirname} (a peer host died or never "
                    f"entered restore); dying so the supervisor "
                    f"restarts the gang")
            time.sleep(0.05)

    def _publish_verdict(self, round_id, nonce, ok, bad, partial,
                         unfit=None):
        self._publish_json(self._verdict_path(self._proc),
                           {"round": round_id, "nonce": nonce,
                            "ok": ok, "bad": bad, "partial": partial,
                            "unfit": unfit or {}},
                           prefix=f".restore.v{self._proc}.")

    def _read_round(self):
        """The current round announcement {"round": id, "mode": m} or
        None. A pre-mode round file (dead older incarnation) reads as
        mode "full" — over-verifying is always safe."""
        try:
            with open(self._round_path()) as f:
                rnd = json.load(f)
        except (OSError, ValueError):
            return None
        if not isinstance(rnd, dict) or rnd.get("round") is None:
            return None
        rnd.setdefault("mode", "full")
        return rnd

    def _verify_own(self, steps, verify, stop_at_first_ok):
        """Walk ``steps`` NEWEST-FIRST verifying this host's share of
        each. A step written by this very world size means this host's
        own shard; a step written by a different nproc means this
        reader runs the full reshard pre-load (``_reshard_load``) — it
        reads and CRC-verifies exactly the writer shards THIS restore
        would touch, once, and the result is cached so the agreed step
        is never read twice. (Verification coverage tracks what is
        restored: a writer shard no reader overlaps is never read, so
        it needs no vote.)

        Returns ``(ok, bad, unfit, cache)``: verified step list,
        {step: error} for positive corruption, {step: reason} for
        steps the reshard plan cannot cover (HEALTHY files — never
        quarantined), and the newest verified step's payload — ONE
        copy retained, tagged ``(step, "own", manifest, arrays)`` or
        ``(step, "reshard", tree, ref, data_states)`` (keeping every
        verified step would hold keep_max model copies in host RAM at
        once). With ``stop_at_first_ok`` the walk stops at the first
        verifying step — the healthy-path restore reads ONE shard (or
        one reshard share), not keep_max of them. Transient OSError
        propagates: crash-and-retry, don't vote."""
        ok, bad, unfit = [], {}, {}
        cache = None
        for s in sorted(steps, reverse=True):
            try:
                W = self._saved_nproc(s)
            except FileNotFoundError:
                continue            # vanished under us (see below)
            except CheckpointCorruptError as e:
                bad[s] = str(e)
                continue
            if W == self._nproc:
                try:
                    manifest, arrays = self._read_own_shard(
                        s, verify, saved_nproc=W)
                except CheckpointCorruptError as e:
                    bad[s] = str(e)
                    continue
                except EnforceNotMet:
                    # the step vanished under us — quarantined by
                    # host 0 (whose prior incarnation died before
                    # publishing its decision) or pruned by a peer.
                    # Neither verified nor positive corruption
                    # evidence: skip it, so the stale entry in our
                    # steps list can't crash the protocol
                    continue
                ok.append(s)
                if cache is None:
                    cache = (s, "own", manifest, arrays)
            else:
                try:
                    tree, ref, dstates = self._reshard_load(
                        s, verify, saved_nproc=W)
                except CheckpointCorruptError as e:
                    bad[s] = str(e)
                    continue
                except CheckpointTopologyError as e:
                    # healthy files the plan cannot cover — reported
                    # distinctly so host 0 refuses instead of
                    # quarantining them
                    unfit[s] = str(e)
                    continue
                except FileNotFoundError:
                    continue        # vanished under us
                ok.append(s)
                if cache is None:
                    cache = (s, "reshard", tree, ref, dstates)
            if stop_at_first_ok:
                break
        return ok, bad, unfit, cache

    @staticmethod
    def _is_partial(steps, ok, bad, unfit):
        return len(ok) + len(bad) + len(unfit) < len(steps)

    def _collect_verdicts(self, round_id, own):
        """Host 0: every host's CURRENT-ROUND verdict (own included).
        A verdict tagged with another round id is a dead incarnation's
        leftover (or a pre-escalation one): keep waiting for the live
        peer — it republishes once it sees this round's
        announcement."""
        def poll():
            verdicts = {0: own}
            for p in range(1, self._nproc):
                try:
                    with open(self._verdict_path(p)) as f:
                        v = json.load(f)
                except (OSError, ValueError):
                    return None         # not published (or mid-write)
                if v.get("round") != round_id:
                    return None         # stale: wait for a fresh one
                verdicts[p] = v
            return verdicts

        return self._await(
            poll, f"peer restore verdicts (.restore.h*.json from "
                  f"{self._nproc} hosts, round {round_id})")

    @staticmethod
    def _common_ok(verdicts):
        common = None
        for v in verdicts.values():
            s = set(int(x) for x in v.get("ok", []))
            common = s if common is None else (common & s)
        return common or set()

    def _lead(self, steps, verify, nonce):
        """Host 0: announce a newest-first "first" round, collect
        verdicts, and — only if the partial ok-sets don't intersect —
        escalate once to a "full" round before agreeing. Quarantines
        the positively-corrupt steps and publishes the nonce-echoed
        decision; when the agreed step was written by a different
        world size the decision carries the reshard plan (from/to
        nproc), and a topology-unfit step NEWER than anything
        restorable publishes a ``topo_error`` decision instead (every
        host raises ``CheckpointTopologyError`` — precise refusal, not
        a collective timeout). Returns (decision, own shard cache, own
        ok, bad). The announcement goes out BEFORE host 0's own CRC
        pass (the escalated round already works this way): followers
        verify in parallel instead of burning their coord_timeout
        budget idle while host 0 reads multi-GB shards."""
        round_id = nonce
        self._publish_json(self._round_path(),
                           {"round": round_id, "mode": "first"},
                           prefix=".restore.r.")
        ok, bad, unfit, cache = self._verify_own(steps, verify,
                                                 stop_at_first_ok=True)
        verdicts = self._collect_verdicts(
            round_id, {"nonce": nonce, "ok": ok, "bad": bad,
                       "unfit": unfit,
                       "partial": self._is_partial(steps, ok, bad,
                                                   unfit)})
        common = self._common_ok(verdicts)
        if not common and any(v.get("partial")
                              for v in verdicts.values()):
            # disagreement with unverified steps in play: one FULL
            # round under a fresh id (followers see the new round and
            # republish after verifying everything)
            round_id = os.urandom(8).hex()
            self._publish_json(self._round_path(),
                               {"round": round_id, "mode": "full"},
                               prefix=".restore.r.")
            ok, bad, unfit, cache = self._verify_own(
                steps, verify, stop_at_first_ok=False)
            verdicts = self._collect_verdicts(
                round_id, {"nonce": nonce, "ok": ok, "bad": bad,
                           "unfit": unfit, "partial": False})
            common = self._common_ok(verdicts)
        chosen = max(common) if common else None
        all_bad = {}
        for p, v in verdicts.items():
            for s, msg in v.get("bad", {}).items():
                all_bad.setdefault(int(s), f"host {p}: {msg}")
        for s in sorted(all_bad, reverse=True):
            self._quarantine(s, all_bad[s])
        all_unfit = {}
        for p, v in verdicts.items():
            for s, msg in v.get("unfit", {}).items():
                all_unfit.setdefault(int(s), f"host {p}: {msg}")
        nonces = {str(p): v.get("nonce") for p, v in verdicts.items()}
        if all_unfit and (chosen is None or max(all_unfit) > chosen):
            # something NEWER than the best restorable step cannot be
            # resharded onto this topology: refuse loudly rather than
            # silently resuming older state (the files are healthy —
            # nothing is quarantined over this)
            s = max(all_unfit)
            decision = {
                "step": None, "nonces": nonces,
                "quarantined": sorted(all_bad),
                "topo_error": (
                    f"checkpoint step {s} in {self.dirname} cannot be "
                    f"restored onto nproc={self._nproc}: "
                    f"{all_unfit[s]} — restart at the written world "
                    f"size (check `fsck_checkpoint.py --nproc`), or "
                    f"re-save the checkpoint")}
            self._publish_json(self._decision_path(), decision,
                               prefix=".restore.d.")
            return decision, cache, ok, bad
        decision = {"step": chosen, "nonces": nonces,
                    "quarantined": sorted(all_bad)}
        if chosen is not None:
            # the reshard plan in the decision is what every host's
            # load path keys on — a meta blip here propagates
            # (retries inside _saved_nproc, then crash-and-retry via
            # the supervisor) rather than silently publishing a
            # fixed-topology decision for a mismatched step
            W_c = self._saved_nproc(chosen)
            if W_c != self._nproc:
                decision["reshard"] = {"from_nproc": W_c,
                                       "to_nproc": self._nproc}
        self._publish_json(self._decision_path(), decision,
                           prefix=".restore.d.")
        return decision, cache, ok, bad

    def _read_decision(self, nonce):
        try:
            with open(self._decision_path()) as f:
                d = json.load(f)
        except (OSError, ValueError):
            return None
        if d.get("nonces", {}).get(str(self._proc)) != nonce:
            return None     # stale decision from a dead incarnation
        return d

    def _follow(self, steps, verify, nonce):
        """Non-zero hosts: wait for host 0's round announcement,
        verify own shards per its mode ("first": newest-first, stop at
        the first good step; "full": every step), publish a
        round-tagged verdict, await the nonce-echoed decision. The
        round file is re-read every poll: a CHANGED round id means
        host 0 escalated to a full round — or died and a new
        incarnation started fresh — and the verdict republishes under
        it instead of leaving host 0 waiting on one tagged for a dead
        round (which would repeat timeout -> restart until the budget
        ran out). Verification work is never repeated: a first-mode
        re-announcement reuses the computed verdict, and full-mode
        verification runs at most once. Returns (decision, own shard
        cache, own ok, bad)."""
        state = {"round": None, "ok": [], "bad": {}, "unfit": {},
                 "cache": None, "mode": None}
        box = {}

        def poll():
            rnd = self._read_round()
            if rnd is None:
                return None
            rid = rnd["round"]
            if rid != state["round"]:
                # protocol progress: a fresh round means host 0 is
                # alive and driving — restart the budget so time spent
                # on the FIRST pass can't starve the full-mode verify
                # this round may demand
                box["deadline"] = (time.monotonic()
                                   + self.coord_timeout)
                mode = rnd["mode"]
                if mode == "full" and state["mode"] != "full":
                    (state["ok"], state["bad"], state["unfit"],
                     state["cache"]) = self._verify_own(
                        steps, verify, stop_at_first_ok=False)
                    state["mode"] = "full"
                elif state["mode"] is None:
                    (state["ok"], state["bad"], state["unfit"],
                     state["cache"]) = self._verify_own(
                        steps, verify, stop_at_first_ok=True)
                    state["mode"] = "first"
                partial = (state["mode"] != "full" and
                           self._is_partial(steps, state["ok"],
                                            state["bad"],
                                            state["unfit"]))
                self._publish_verdict(rid, nonce, state["ok"],
                                      state["bad"], partial,
                                      unfit=state["unfit"])
                state["round"] = rid
            return self._read_decision(nonce)

        decision = self._await(
            poll, "host 0's restore round + decision "
                  "(.restore.round.json / .restore.decision.json)",
            deadline_box=box)
        return decision, state["cache"], state["ok"], state["bad"]

    def _restore_coordinated(self, verify):
        steps = self._complete_steps()
        enforce(steps, f"no checkpoint in {self.dirname}")
        newest = steps[-1]
        nonce = os.urandom(8).hex()
        if self._proc == 0:
            decision, cache, ok, bad = self._lead(steps, verify, nonce)
        else:
            decision, cache, ok, bad = self._follow(steps, verify,
                                                    nonce)
        if decision.get("topo_error"):
            raise CheckpointTopologyError(decision["topo_error"])
        chosen = decision.get("step")
        if chosen is None:
            raise CheckpointCorruptError(
                f"no checkpoint step in {self.dirname} verified on "
                f"every host (this host: {len(ok)} ok, {len(bad)} "
                f"bad); nothing safe to restore")
        chosen = int(chosen)
        # the DECISION carries the topology verdict — no meta re-read
        # here, so the healthy cache-hit path stays I/O-free and a
        # meta pruned/quarantined between decision and load can't
        # crash an already-agreed restore
        plan = decision.get("reshard")
        if plan:
            # the agreed step was written by a different world size:
            # every host re-slices its share per the decision's
            # reshard plan (integrity applies to every shard touched;
            # the verification pass already did — and cached — exactly
            # this work for the newest ok step)
            if cache is not None and cache[0] == chosen \
                    and cache[1] == "reshard":
                tree, _ref, dstates = cache[2], cache[3], cache[4]
            else:
                tree, _ref, dstates = self._reshard_load(
                    chosen, verify,
                    saved_nproc=int(plan["from_nproc"]))
            _m_reshard.inc()
            ds = _PendingMerge(dstates)
        else:
            if cache is not None and cache[0] == chosen \
                    and cache[1] == "own":
                manifest, arrays = cache[2], cache[3]
            else:
                # no reshard plan in the decision == the agreed step
                # was written by THIS world size; passing it through
                # skips the meta re-read here too (a meta pruned by a
                # stale incarnation between decision and load must not
                # crash an already-agreed restore)
                manifest, arrays = self._read_own_shard(
                    chosen, verify, saved_nproc=self._nproc)
            tree = self._tree_of(manifest, arrays)
            ds = manifest.get("data_state")
        if verify:
            self._last_verified = chosen
        self._restored_data_state = (chosen, ds)
        if chosen != newest:
            # the restart-from-fallback line (docs/DEBUGGING.md)
            _log.warning(
                "restored from last-good checkpoint step %s after "
                "cross-host agreement (newest complete step was %s, "
                "%d corrupt step(s) quarantined)", chosen, newest,
                len(decision.get("quarantined", [])))
        return tree, chosen

    def restore_data_state(self, step):
        """The data-pipeline cursor saved with ``step``, or None when
        the step predates data_state / none was saved. For a step
        written by this very world size that is this host's own shard
        manifest's cursor; for a different written nproc it is the
        job-level frontier merged from every writer's cursor (see
        ``_merge_data_states``). Cached from the restore() that just
        loaded the step, so the common path rereads nothing."""
        cached = self._restored_data_state
        if cached is not None and cached[0] == step:
            if isinstance(cached[1], _PendingMerge):
                merged = self._merge_data_states(step, cached[1].states)
                self._restored_data_state = (step, merged)
                return merged
            return cached[1]
        # cold path (restore() didn't just load this step): same shard
        # resolution as _load_step_any — shard0 substitutes only for a
        # replicated single-host save (another host's cursor would be
        # the wrong host's position)
        try:
            saved_nproc = self._saved_nproc(step)
        except (OSError, CheckpointCorruptError):
            saved_nproc = None
        if saved_nproc is not None and saved_nproc != self._nproc \
                and saved_nproc != 1:
            # changed topology: the per-writer cursors only make sense
            # merged into one frontier
            states = [
                self._read_shard_manifest(
                    self._shard_path(step, p)).get("data_state")
                for p in range(saved_nproc)]
            return self._merge_data_states(step, states)
        path = self._shard_path(step)
        if not os.path.exists(path):
            enforce(saved_nproc == 1,
                    f"checkpoint step {step}: no shard for host "
                    f"{self._proc} to read data_state from")
            path = self._shard_path(step, 0)
        manifest, _ = verify_shard(path, verify=self.verify_restore)
        return manifest.get("data_state")

    def close(self):
        if self._thread is not None:
            self.wait()
            self._q.put(None)
            self._thread.join(timeout=10)
            self._thread = None
        self._pool.clear()          # the pinned host buffers go back


def auto_checkpoint(dirname, init_state_fn, total_steps, step_fn,
                    save_interval_steps=100, keep_max=3,
                    data_state=None, proc=None, nproc=None,
                    shard_axes=None, device=None):
    """Run ``state = step_fn(step, state)`` for steps [resume..total),
    checkpointing every interval and resuming from the newest
    *verified* checkpoint if one exists (corrupt newer steps are
    quarantined and walked past — see ``CheckpointManager.restore``).
    Returns the final state.

    ``data_state``: an object with ``state()``/``set_state(s)``
    (``FileDataLoader(stateful=True)`` qualifies). Its cursor is saved
    with every checkpoint and restored *before* the loop, so a
    killed-and-resumed run consumes exactly the record sequence an
    uninterrupted run would — create the loader's iterator inside
    ``step_fn`` (first use), after the restore has applied the state.

    ``proc``/``nproc``: this rank's identity in a SHARED checkpoint
    dir (e.g. ``PADDLE_TRAINER_ID`` / ``PADDLE_TRAINERS_NUM`` under
    the elastic launcher — the incarnation's world size). When a
    restart's nproc differs from the one that wrote the newest
    checkpoint, restore re-shards it (see ``CheckpointManager``).
    ``shard_axes`` annotates the state tree for that: a congruent
    pytree of per-leaf shard axes (None = replicated), passed to every
    ``save``.

    ``device``: where a restored state's tensors go (the card unless the
    caller asks for the CPU); ``init_state_fn`` places a fresh state
    itself.

    Kill the process at any point and re-invoking continues from the last
    saved step. The supervisor hookups, each a no-op without its
    environment variable:

    - every step touches this rank's heartbeat file
      (PADDLE_HEARTBEAT_DIR, see distributed/health.py) so the
      launcher's --hang_timeout watchdog can tell hung from slow;
    - SIGTERM (pod preemption, forwarded by the launcher with a
      --grace_period window) checkpoints the current state, waits for
      the async writer to publish it, and exits 143 — preemption never
      loses more than the in-flight step;
    - the flight recorder is armed (PADDLE_POSTMORTEM_DIR), distributed
      tracing is armed (PADDLE_TRACE_DIR — per-step span trees land in
      <log_dir>/traces and the launcher merges them into one Perfetto
      timeline, see monitor/trace.py), and a metrics snapshot is
      exported next to the heartbeat file (monitor/exporter.py) — a
      supervised job leaves telemetry and postmortems without any
      per-script wiring.
    """
    from paddle_tpu_torch.distributed.health import Heartbeat
    from paddle_tpu_torch.monitor import flight_recorder
    from paddle_tpu_torch.monitor import trace as _trace_mod
    from paddle_tpu_torch.monitor.exporter import RankExporter
    device = resolve_device(device)
    flight_recorder.install_from_env()
    _trace_mod.install_from_env()
    _goodput.install_from_env()
    exp = RankExporter.from_env()
    if exp is not None:
        exp.start()
    mgr = CheckpointManager(dirname, keep_max=keep_max,
                            save_interval_steps=save_interval_steps,
                            proc=proc, nproc=nproc)
    hb = Heartbeat.from_env()
    preempted = threading.Event()
    restore_handler = None
    if threading.current_thread() is threading.main_thread():
        prev = signal.signal(signal.SIGTERM,
                             lambda s, f: preempted.set())
        restore_handler = lambda: signal.signal(signal.SIGTERM, prev)
    def _ds():
        return data_state.state() if data_state is not None else None

    try:
        restored = False
        if mgr.latest_step() is not None:
            try:
                # walk-back restore: a corrupt newest step is
                # quarantined and the previous verified one loads
                state, start = mgr.restore(device=device)
                restored = True
            except CheckpointCorruptError as e:
                # EVERY step failed verification. Starting over is the
                # only move left — and strictly better than the
                # supervisor burning its restart budget re-crashing
                # into the same bad file
                _log.error("all checkpoints in %s corrupt (%s); "
                           "starting from scratch", dirname, e)
        if restored:
            if data_state is not None:
                ds = mgr.restore_data_state(start)
                if ds is not None:
                    data_state.set_state(ds)
            _goodput.on_restore(start)
            start += 1
        else:
            state, start = init_state_fn(), 0
        for step in range(start, total_steps):
            _goodput.on_step(step)
            state = step_fn(step, state)
            if hb is not None:
                hb.beat()
            saved = mgr.maybe_save(step, state, data_state=_ds(),
                                   axes=shard_axes)
            if preempted.is_set():
                # flush inside the launcher's grace window: save the
                # completed step (unless the interval policy just did —
                # a second identical write would eat into the scarce
                # grace budget), drain the async writer (meta published
                # = checkpoint complete), then report SIGTERM death
                if not saved:
                    mgr.save(step, state, data_state=_ds(),
                             axes=shard_axes)
                mgr.wait()
                # this handler shadows the flight recorder's SIGTERM
                # hook while the loop runs, so dump explicitly: a
                # preempted rank leaves evidence too (SystemExit
                # bypasses sys.excepthook)
                if flight_recorder.is_enabled():
                    flight_recorder.dump(reason="preempted")
                raise SystemExit(143)
        mgr.save(total_steps - 1, state, data_state=_ds(),
                 axes=shard_axes)
        return state
    finally:
        if restore_handler is not None:
            restore_handler()
        mgr.close()             # drain the async writer FIRST, so the
        _goodput.flush_idle()   # ledger tail closed before the final
        if exp is not None:     # snapshot, so per-rank phase seconds
            exp.stop()          # sum to the wall gauge

