"""The port's checkpoints (``paddle_tpu_torch/io_checkpoint.py``), on the
CPU: the behaviour cases of the JAX package's ``tests/test_checkpoint.py``,
``tests/test_ckpt_integrity.py`` (verification, last-good fallback,
transient I/O, directory pathologies, the shared-directory round with two
managers on threads, data state) and ``tests/test_reshard.py`` (axes,
re-slicing across world sizes, uneven extents, topology refusals, merged
cursors) run against the port's manager; then checkpoints written by each
package restored by the other bitwise, ``auto_checkpoint`` on ``bert_tiny``
against the JAX package's, a crash and a resume against an uninterrupted
run, the snapshot under in-place updates, SIGTERM in a child process, the
bf16 refusal, the build cache and the save/load ops' files.

The behaviour cases restore onto the CPU: the module's default device
(the card; ``tests/test_torch_hygiene.py`` holds that rule) is the CPU for
them, by the ``_cpu_default`` fixture.
"""

import json
import logging
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import paddle_tpu_torch.io_checkpoint as ioc
from paddle_tpu.testing import faults
from paddle_tpu_torch.dataio.dataloader import merge_rank_states
from paddle_tpu_torch.io_checkpoint import (
    CheckpointCorruptError, CheckpointManager, CheckpointTopologyError,
    _integrity_block, auto_checkpoint, even_interval, verify_shard,
)
from paddle_tpu_torch.monitor.registry import REGISTRY

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cpu_default(monkeypatch):
    monkeypatch.setattr(
        ioc, "resolve_device",
        lambda d=None: torch.device("cpu" if d is None else d))


# ---------------------------------------------------------------------------
# helpers of the JAX package's test files
# ---------------------------------------------------------------------------
def _tstate(v):
    return {"w": torch.full((4,), float(v)), "step": torch.tensor(v)}


def _state(v):
    return {"w": np.full((4,), float(v)), "opt": [np.ones(3), float(v)]}


def _mgr(path, **kw):
    kw.setdefault("async_save", False)
    kw.setdefault("save_interval_steps", 1)
    return CheckpointManager(str(path), **kw)


def _rmgr(path, proc, nproc, **kw):
    kw.setdefault("async_save", False)
    kw.setdefault("save_interval_steps", 1)
    kw.setdefault("keep_max", 10)
    return CheckpointManager(str(path), proc=proc, nproc=nproc, **kw)


def _shard(path, step, proc=0):
    return os.path.join(str(path), f"ckpt_{step}.shard{proc}.npz")


def _meta(path, step):
    return os.path.join(str(path), f"ckpt_{step}.json")


def _tamper_array(path, key, manifest_too=False):
    """Rewrite a shard with one array's data changed but the recorded
    CRCs untouched: bit rot the zip layer cannot see, only the
    manifest's recorded digests can."""
    with np.load(path, allow_pickle=False) as blob:
        arrays = {k: blob[k].copy() for k in blob.files
                  if k != "__manifest__"}
        mblob = blob["__manifest__"].copy()
    arrays[key] = arrays[key] + 1
    if manifest_too:
        m = json.loads(bytes(mblob.tobytes()).decode())
        m["data_state"] = {"rotted": True}
        mblob = np.frombuffer(json.dumps(m).encode(), dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez(f, __manifest__=mblob, **arrays)


def _host_mgr(path, proc, nproc, **kw):
    """A manager as host ``proc`` of ``nproc``: the coordination protocol
    is files, so forcing the host tag during ``__init__`` (the stale-temp
    sweep runs as that host) exercises it faithfully."""
    orig = ioc._host_tag
    ioc._host_tag = lambda: (proc, nproc)
    try:
        return _mgr(path, **kw)
    finally:
        ioc._host_tag = orig


def _sharded_state(proc, nproc, step, rows=10):
    """Host ``proc``'s slice of a job-level state: `w` sharded along
    axis 0, a replicated nested opt list, and an inline scalar."""
    lo, hi = even_interval(rows, nproc, proc)
    return {"w": np.arange(float(rows))[lo:hi] + step,
            "opt": [np.full((3, 2), float(step)), ("m", float(step))],
            "n": 7}


_AXES = {"w": 0, "opt": [None, (None, None)], "n": None}


def _save_all_hosts(path, step, nproc, state_fn=_sharded_state,
                    axes=_AXES, data_states=None, **kw):
    """One complete multi-host step: every host's shard, host 0 last."""
    for p in list(range(1, nproc)) + [0]:
        m = _rmgr(path, p, nproc, **kw)
        ds = data_states[p] if data_states is not None else None
        m.save(step, state_fn(p, nproc, step), data_state=ds, axes=axes)
        m.close()


def _strip_array_info(path):
    """Rewrite a shard as an older writer would have: no ``array_info``,
    integrity recomputed consistently."""
    with np.load(path, allow_pickle=False) as blob:
        arrays = {k: blob[k].copy() for k in blob.files
                  if k != "__manifest__"}
        manifest = json.loads(
            bytes(blob["__manifest__"].tobytes()).decode("utf-8"))
    body = {k: v for k, v in manifest.items()
            if k not in ("integrity", "array_info")}
    manifest = dict(body, integrity=_integrity_block(body, arrays))
    mblob = np.frombuffer(json.dumps(manifest).encode("utf-8"),
                          dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez(f, __manifest__=mblob, **arrays)


# ---------------------------------------------------------------------------
# the JAX package's behaviour cases, against the port's manager
# ---------------------------------------------------------------------------
class TestCheckpointManager:
    def test_save_restore_roundtrip(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), save_interval_steps=1)
        mgr.save(3, _tstate(3))
        mgr.wait()
        assert mgr.latest_step() == 3
        tree, step = mgr.restore()
        assert step == 3
        np.testing.assert_allclose(np.asarray(tree["w"]), 3.0)
        mgr.close()

    def test_keep_max_prunes(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep_max=2,
                                save_interval_steps=1)
        for s in range(5):
            mgr.save(s, _tstate(s))
        mgr.wait()
        files = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
        assert len(files) == 2
        assert mgr.latest_step() == 4
        mgr.close()

    def test_restore_survives_new_manager(self, tmp_path):
        m1 = CheckpointManager(str(tmp_path), save_interval_steps=1)
        m1.save(7, _tstate(7))
        m1.close()
        m2 = CheckpointManager(str(tmp_path))
        tree, step = m2.restore()
        assert step == 7 and float(tree["w"][0]) == 7.0
        m2.close()

    def test_interval_policy(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), save_interval_steps=5)
        assert mgr.should_save(0) and mgr.should_save(5)
        assert not mgr.should_save(3)
        mgr.close()

    def test_sync_mode(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_save=False,
                                save_interval_steps=1)
        mgr.save(1, _tstate(1))
        assert mgr.latest_step() == 1
        mgr.close()


class TestAutoCheckpoint:
    def test_full_run(self, tmp_path):
        out = auto_checkpoint(
            str(tmp_path), lambda: _tstate(0), 10,
            lambda step, st: {"w": st["w"] + 1.0,
                              "step": torch.tensor(step)},
            save_interval_steps=3)
        np.testing.assert_allclose(np.asarray(out["w"]), 10.0)

    def test_resume_after_crash(self, tmp_path):
        calls = []

        def crashing_step(step, st):
            calls.append(step)
            if step == 6 and len([c for c in calls if c == 6]) == 1:
                raise RuntimeError("preempted")
            return {"w": st["w"] + 1.0, "step": torch.tensor(step)}

        with pytest.raises(RuntimeError):
            auto_checkpoint(str(tmp_path), lambda: _tstate(0), 10,
                            crashing_step, save_interval_steps=2)
        # resume: must restart from the last completed interval, not 0
        calls2 = []

        def step2(step, st):
            calls2.append(step)
            return {"w": st["w"] + 1.0, "step": torch.tensor(step)}

        out = auto_checkpoint(str(tmp_path), lambda: _tstate(0), 10,
                              step2, save_interval_steps=2)
        assert calls2[0] > 0, "resumed from scratch"
        np.testing.assert_allclose(np.asarray(out["w"]), 10.0)


class TestVerifyShard:
    def test_roundtrip_records_and_passes_integrity(self, tmp_path):
        mgr = _mgr(tmp_path)
        mgr.save(1, _state(1))
        manifest, arrays = verify_shard(_shard(tmp_path, 1))
        integ = manifest["integrity"]
        assert integ["algo"] == "crc32"
        assert set(integ["arrays"]) == set(arrays)
        mgr.close()

    def test_zip_level_bitflip_detected(self, tmp_path):
        mgr = _mgr(tmp_path)
        mgr.save(1, _state(1))
        mgr.close()
        faults.corrupt_checkpoint(_shard(tmp_path, 1), "bitflip")
        with pytest.raises(CheckpointCorruptError) as ei:
            verify_shard(_shard(tmp_path, 1))
        assert "ckpt_1.shard0.npz" in str(ei.value)

    def test_torn_shard_detected(self, tmp_path):
        mgr = _mgr(tmp_path)
        mgr.save(1, _state(1))
        mgr.close()
        faults.corrupt_checkpoint(_shard(tmp_path, 1), "torn")
        with pytest.raises(CheckpointCorruptError):
            verify_shard(_shard(tmp_path, 1))

    def test_recorded_crc_mismatch_names_first_bad_array(self, tmp_path):
        """Zip-consistent rot: the manifest's recorded CRC is the only
        witness, and the error names the file, the npz key, AND the
        tree path of the first bad array."""
        mgr = _mgr(tmp_path)
        mgr.save(1, _state(1))
        mgr.close()
        _tamper_array(_shard(tmp_path, 1), "a0")
        with pytest.raises(CheckpointCorruptError) as ei:
            verify_shard(_shard(tmp_path, 1))
        msg = str(ei.value)
        assert "ckpt_1.shard0.npz" in msg
        assert "'a0'" in msg and "/w" in msg and "crc32" in msg

    def test_manifest_rot_detected(self, tmp_path):
        mgr = _mgr(tmp_path)
        mgr.save(1, _state(1), data_state={"epoch": 0})
        mgr.close()
        path = _shard(tmp_path, 1)
        with np.load(path, allow_pickle=False) as blob:
            arrays = {k: blob[k].copy() for k in blob.files
                      if k != "__manifest__"}
            m = json.loads(bytes(blob["__manifest__"].tobytes()).decode())
        m["data_state"] = {"epoch": 999}        # rot the resume cursor
        mblob = np.frombuffer(json.dumps(m).encode(), dtype=np.uint8)
        with open(path, "wb") as f:
            np.savez(f, __manifest__=mblob, **arrays)
        with pytest.raises(CheckpointCorruptError) as ei:
            verify_shard(path)
        assert "manifest" in str(ei.value)

    def test_verify_false_skips_crc(self, tmp_path):
        mgr = _mgr(tmp_path)
        mgr.save(1, _state(1))
        mgr.close()
        _tamper_array(_shard(tmp_path, 1), "a0")
        manifest, arrays = verify_shard(_shard(tmp_path, 1),
                                        verify=False)
        assert "a0" in arrays

    def test_legacy_shard_without_integrity_accepted(self, tmp_path):
        """Pre-integrity checkpoints (no integrity block) must stay
        restorable."""
        mgr = _mgr(tmp_path)
        mgr.save(1, _state(1))
        mgr.close()
        path = _shard(tmp_path, 1)
        with np.load(path, allow_pickle=False) as blob:
            arrays = {k: blob[k].copy() for k in blob.files
                      if k != "__manifest__"}
            m = json.loads(bytes(blob["__manifest__"].tobytes()).decode())
        del m["integrity"]
        mblob = np.frombuffer(json.dumps(m).encode(), dtype=np.uint8)
        with open(path, "wb") as f:
            np.savez(f, __manifest__=mblob, **arrays)
        tree, step = _mgr(tmp_path).restore()
        assert step == 1 and float(tree["w"][0]) == 1.0


class TestLastGoodFallback:
    def _saved(self, tmp_path, steps=(1, 2, 3)):
        mgr = _mgr(tmp_path, keep_max=10)
        for s in steps:
            mgr.save(s, _state(s), data_state={"records_consumed": s})
        mgr.close()

    def test_corrupt_newest_falls_back_and_quarantines(self, tmp_path):
        self._saved(tmp_path)
        faults.corrupt_checkpoint(_shard(tmp_path, 3), "bitflip")
        before = REGISTRY.get("corrupt_checkpoints_total").value()
        mgr = _mgr(tmp_path)
        tree, step = mgr.restore()
        assert step == 2 and float(tree["w"][0]) == 2.0
        assert REGISTRY.get("corrupt_checkpoints_total").value() \
            == before + 1
        assert os.path.exists(_shard(tmp_path, 3) + ".corrupt")
        assert os.path.exists(_meta(tmp_path, 3) + ".corrupt")
        assert not os.path.exists(_shard(tmp_path, 3))
        # the quarantined step is gone from the restore path for good
        assert mgr.latest_step() == 2
        # and the fallback's data cursor is served, not the corrupt one
        assert mgr.restore_data_state(step) == {"records_consumed": 2}
        mgr.close()

    def test_two_corrupt_steps_walks_back_twice(self, tmp_path):
        self._saved(tmp_path)
        faults.corrupt_checkpoint(_shard(tmp_path, 3), "torn")
        faults.corrupt_checkpoint(_shard(tmp_path, 2), "bitflip")
        mgr = _mgr(tmp_path)
        tree, step = mgr.restore()
        assert step == 1
        mgr.close()

    def test_zero_byte_shard_falls_back(self, tmp_path):
        self._saved(tmp_path)
        open(_shard(tmp_path, 3), "w").close()
        mgr = _mgr(tmp_path)
        tree, step = mgr.restore()
        assert step == 2
        mgr.close()

    def test_explicit_step_raises_not_quarantines(self, tmp_path):
        self._saved(tmp_path)
        faults.corrupt_checkpoint(_shard(tmp_path, 3), "torn")
        mgr = _mgr(tmp_path)
        with pytest.raises(CheckpointCorruptError) as ei:
            mgr.restore(step=3)
        assert "ckpt_3.shard0.npz" in str(ei.value)
        # explicit-step failure leaves the evidence in place untouched
        assert os.path.exists(_shard(tmp_path, 3))
        mgr.close()

    def test_all_corrupt_raises_checkpoint_corrupt(self, tmp_path):
        self._saved(tmp_path, steps=(1, 2))
        faults.corrupt_checkpoint(_shard(tmp_path, 1), "torn")
        faults.corrupt_checkpoint(_shard(tmp_path, 2), "torn")
        with pytest.raises(CheckpointCorruptError):
            _mgr(tmp_path).restore()

    def test_auto_checkpoint_restarts_from_scratch_when_all_corrupt(
            self, tmp_path):
        """The bricked-job scenario: every checkpoint
        rotted. auto_checkpoint must start over, not crash-loop."""
        self._saved(tmp_path, steps=(1, 2))
        faults.corrupt_checkpoint(_shard(tmp_path, 1), "torn")
        faults.corrupt_checkpoint(_shard(tmp_path, 2), "torn")
        seen = []
        out = auto_checkpoint(
            str(tmp_path), lambda: {"w": 0.0}, 4,
            lambda s, st: (seen.append(s), {"w": st["w"] + 1.0})[1],
            save_interval_steps=100)
        assert seen[0] == 0 and float(out["w"]) == 4.0


class TestTransientIO:
    """A transient OSError (NFS hiccup, EIO) is NOT corruption: the
    read retries and then the OSError re-raises, so the supervisor's
    restart budget handles it — the newest good checkpoint must never
    be quarantined over a disk blip."""

    def test_flaky_read_retried_then_verifies(self, tmp_path,
                                              monkeypatch):
        import paddle_tpu_torch.io_checkpoint as ioc
        mgr = _mgr(tmp_path)
        mgr.save(1, _state(1))
        mgr.close()
        real_load = np.load
        calls = []

        def flaky(path, **kw):
            calls.append(path)
            if len(calls) <= 2:
                raise OSError(5, "Input/output error")
            return real_load(path, **kw)

        monkeypatch.setattr(ioc.np, "load", flaky)
        manifest, arrays = verify_shard(_shard(tmp_path, 1),
                                        retry_delay=0.001)
        assert "integrity" in manifest and len(calls) == 3

    def test_persistent_oserror_raises_oserror_not_corrupt(
            self, tmp_path, monkeypatch):
        import paddle_tpu_torch.io_checkpoint as ioc
        mgr = _mgr(tmp_path)
        mgr.save(1, _state(1))
        mgr.close()

        def dead(path, **kw):
            raise OSError(5, "Input/output error")

        monkeypatch.setattr(ioc.np, "load", dead)
        with pytest.raises(OSError) as ei:
            verify_shard(_shard(tmp_path, 1), retry_delay=0.001)
        assert not isinstance(ei.value, CheckpointCorruptError)

    def test_restore_does_not_quarantine_on_transient_error(
            self, tmp_path, monkeypatch):
        """restore(step=None) must crash-and-retry on I/O errors, not
        demote the newest (good!) checkpoint to *.corrupt."""
        import paddle_tpu_torch.io_checkpoint as ioc
        mgr = _mgr(tmp_path, keep_max=10)
        for s in (1, 2):
            mgr.save(s, _state(s))
        mgr.close()
        before = REGISTRY.get("corrupt_checkpoints_total").value()

        def dead(path, **kw):
            raise OSError(5, "Input/output error")

        monkeypatch.setattr(ioc.np, "load", dead)
        with pytest.raises(OSError):
            _mgr(tmp_path).restore()
        monkeypatch.undo()
        assert REGISTRY.get("corrupt_checkpoints_total").value() \
            == before
        assert os.path.exists(_shard(tmp_path, 2))      # untouched
        assert not os.path.exists(_shard(tmp_path, 2) + ".corrupt")
        # and once the disk heals, the same dir restores the newest
        # (undo() took the CPU default away too: asked for explicitly)
        tree, step = _mgr(tmp_path).restore(device="cpu")
        assert step == 2

    def test_step_complete_shard_stat_blip_retried(self, tmp_path,
                                                   monkeypatch):
        """os.path.exists swallows EVERY OSError into False — a stat
        blip (ESTALE) on the newest step's shard would silently drop
        it from _complete_steps. The presence probe must retry the
        blip and still count the step."""
        import paddle_tpu_torch.io_checkpoint as ioc
        mgr = _mgr(tmp_path, keep_max=10)
        for s in (1, 2):
            mgr.save(s, _state(s))
        mgr.close()
        shard2 = _shard(tmp_path, 2)
        real_stat = os.stat
        calls = {"n": 0}

        def flaky(path, *a, **kw):
            if os.fspath(path) == shard2:
                calls["n"] += 1
                if calls["n"] <= 2:
                    raise OSError(116, "Stale file handle")
            return real_stat(path, *a, **kw)

        monkeypatch.setattr(ioc.os, "stat", flaky)
        assert _mgr(tmp_path).latest_step() == 2
        monkeypatch.undo()
        assert calls["n"] == 3

    def test_restore_meta_blip_retried_not_fatal(self, tmp_path,
                                                 monkeypatch):
        """The META read on the restore path (_read_own_shard) gets
        the same transient-retry treatment as every other read: one
        NFS blip on ckpt_N.json must not crash the host (multi-host,
        it would also burn every peer's coord_timeout mid-protocol)."""
        import builtins
        mgr = _mgr(tmp_path)
        mgr.save(1, _state(1))
        mgr.close()
        meta = _meta(tmp_path, 1)
        real_open = builtins.open
        calls = {"n": 0}

        def flaky_open(path, *a, **kw):
            if os.fspath(path) == meta:
                calls["n"] += 1
                if calls["n"] <= 2:
                    raise OSError(5, "Input/output error")
            return real_open(path, *a, **kw)

        monkeypatch.setattr(builtins, "open", flaky_open)
        m2 = _mgr(tmp_path)
        tree, step = m2.restore(step=1)     # explicit: no walk-back
        m2.close()
        assert step == 1 and calls["n"] == 3
        assert float(tree["w"][0]) == 1.0

    def test_step_complete_meta_blip_retried_not_dropped(
            self, tmp_path, monkeypatch):
        """A transient I/O error reading ckpt_N.json must not silently
        classify the step as incomplete — restore would quietly fall
        back past the newest GOOD step with no warning. The read
        retries like shard reads do."""
        import paddle_tpu_torch.io_checkpoint as ioc
        mgr = _mgr(tmp_path)
        mgr.save(1, _state(1))
        mgr.close()
        m2 = _mgr(tmp_path)
        real = ioc.json.load
        calls = []

        def flaky(f, **kw):
            calls.append(1)
            if len(calls) <= 2:
                raise OSError(5, "Input/output error")
            return real(f, **kw)

        monkeypatch.setattr(ioc.json, "load", flaky)
        assert m2._step_complete(1, retry_delay=0.001)
        assert len(calls) == 3
        m2.close()

    def test_step_complete_persistent_meta_error_raises(
            self, tmp_path, monkeypatch):
        import paddle_tpu_torch.io_checkpoint as ioc
        mgr = _mgr(tmp_path)
        mgr.save(1, _state(1))
        mgr.close()
        m2 = _mgr(tmp_path)

        def dead(f, **kw):
            raise OSError(5, "Input/output error")

        monkeypatch.setattr(ioc.json, "load", dead)
        with pytest.raises(OSError):
            m2._step_complete(1, retry_delay=0.001)
        m2.close()


class TestDirPathologies:
    def test_meta_without_shard_ignored(self, tmp_path):
        mgr = _mgr(tmp_path, keep_max=10)
        mgr.save(1, _state(1))
        mgr.save(2, _state(2))
        os.remove(_shard(tmp_path, 2))
        assert mgr.latest_step() == 1       # stray meta doesn't brick
        tree, step = mgr.restore()
        assert step == 1
        mgr.close()

    def test_stray_meta_alone_means_no_checkpoint(self, tmp_path):
        with open(_meta(tmp_path, 5), "w") as f:
            json.dump({"step": 5, "nproc": 1}, f)
        mgr = _mgr(tmp_path)
        assert mgr.latest_step() is None
        mgr.close()

    def test_torn_meta_json_ignored(self, tmp_path):
        mgr = _mgr(tmp_path, keep_max=10)
        mgr.save(1, _state(1))
        with open(_meta(tmp_path, 2), "w") as f:
            f.write('{"step": 2, "npro')      # killed mid-write
        assert mgr.latest_step() == 1
        mgr.close()

    def test_stale_tmps_swept_on_init(self, tmp_path):
        for f in (".ckpt_5.shard0.abc123.tmp.npz",
                  "ckpt_5.shard0.npz.tmp.npz",       # pre-mkstemp name
                  "ckpt_5.json.tmp",                 # legacy meta temp
                  ".ckpt_5.meta.abc123.json.tmp",    # mkstemp meta temp
                  ".restore.v0.xyz.json.tmp",        # own verdict temp
                  ".restore.r.xyz.json.tmp",         # round temp
                  ".restore.d.xyz.json.tmp",         # decision temp
                  ".restore.h0.json",                # own stale verdict
                  ".restore.round.json",             # stale round
                  ".restore.decision.json"):         # stale decision
            open(os.path.join(str(tmp_path), f), "w").close()
        mgr = _mgr(tmp_path)
        left = [f for f in os.listdir(str(tmp_path))
                if ".tmp" in f or f.startswith(".restore.")]
        assert left == []
        mgr.close()

    def test_sweep_leaves_other_hosts_tmps(self, tmp_path):
        others = [os.path.join(str(tmp_path), f)
                  for f in (".ckpt_5.shard1.xyz.tmp.npz",
                            ".restore.h1.json",      # host 1's verdict
                            ".restore.v1.xyz.json.tmp")]  # and its
        # in-flight verdict temp: host 1 may be mid-_publish_json
        # while this host inits — yanking it would crash its
        # os.replace and cost a gang restart
        for f in others:
            open(f, "w").close()
        mgr = _mgr(tmp_path)            # this host is shard0
        for f in others:
            assert os.path.exists(f), f
        mgr.close()

    def test_quarantined_step_excluded_from_keep_max(self, tmp_path):
        """A quarantined step must not eat a keep_max slot: after the
        quarantine, keep_max GOOD steps survive pruning."""
        mgr = _mgr(tmp_path, keep_max=2)
        for s in (1, 2, 3):
            mgr.save(s, _state(s))
        faults.corrupt_checkpoint(_shard(tmp_path, 3), "bitflip")
        tree, step = mgr.restore()          # quarantines 3
        assert step == 2
        mgr.save(4, _state(4))              # complete: {1, 2, 4}
        steps = mgr._complete_steps()
        assert steps == [2, 4], steps       # 2 kept, .corrupt not counted
        assert os.path.exists(_shard(tmp_path, 3) + ".corrupt")
        mgr.close()

    def test_prune_keeps_last_verified_step(self, tmp_path):
        m1 = _mgr(tmp_path, keep_max=3)
        for s in (1, 2, 3):
            m1.save(s, _state(s))
        m1.close()
        m2 = _mgr(tmp_path, keep_max=1)
        tree, step = m2.restore()           # verifies 3 on read
        assert step == 3
        m2.save(10, _state(10))
        m2.save(11, _state(11))
        steps = m2._complete_steps()
        # keep_max=1 would leave only 11 — but 3 is the newest step
        # PROVEN restorable, and pruning it would bet the job on an
        # unverified write
        assert steps == [3, 11], steps
        m2.close()


class TestSharedDirMultiHost:
    """restore(step=None) on a SHARED checkpoint dir is a collective:
    hosts must agree on ONE step, or ranks silently resume from
    different steps and data-parallel training corrupts."""

    def _save_two_host(self, tmp_path, steps):
        m1 = _host_mgr(tmp_path, 1, 2, keep_max=10)
        m0 = _host_mgr(tmp_path, 0, 2, keep_max=10)
        for s in steps:
            m1.save(s, _state(s))       # shard1 first: host 0 waits
            m0.save(s, _state(s))       # for peers before the meta
        m1.close()
        m0.close()

    def _restore_both(self, m0, m1, timeout=30.0):
        import threading
        m0.coord_timeout = m1.coord_timeout = timeout
        res, errs = {}, {}

        def run(tag, m):
            try:
                res[tag] = m.restore()
            except Exception as e:      # noqa: BLE001 — re-asserted
                errs[tag] = e

        t = threading.Thread(target=run, args=(1, m1), daemon=True)
        t.start()
        run(0, m0)
        t.join(timeout)
        assert not t.is_alive(), "host 1 restore hung"
        return res, errs

    def test_one_hosts_corrupt_shard_walks_both_hosts_back(
            self, tmp_path):
        """The divergence bug: host 1's shard of step 3 is rotted,
        host 0's verifies. Without coordination host 0 restores 3 and
        host 1 restores 2. Both must restore 2."""
        self._save_two_host(tmp_path, (1, 2, 3))
        faults.corrupt_checkpoint(_shard(tmp_path, 3, proc=1),
                                  "bitflip")
        before = REGISTRY.get("corrupt_checkpoints_total").value()
        res, errs = self._restore_both(_host_mgr(tmp_path, 0, 2),
                                       _host_mgr(tmp_path, 1, 2))
        assert not errs, errs
        assert res[0][1] == res[1][1] == 2
        assert float(res[0][0]["w"][0]) == 2.0
        assert float(res[1][0]["w"][0]) == 2.0
        # the WHOLE step is quarantined — host 0's healthy shard too,
        # else it leaks forever once the meta is renamed
        assert os.path.exists(_shard(tmp_path, 3, 0) + ".corrupt")
        assert os.path.exists(_shard(tmp_path, 3, 1) + ".corrupt")
        assert os.path.exists(_meta(tmp_path, 3) + ".corrupt")
        assert not os.path.exists(_shard(tmp_path, 3, 0))
        assert REGISTRY.get("corrupt_checkpoints_total").value() \
            == before + 1

    def test_healthy_shared_dir_restores_newest_on_both(self, tmp_path):
        self._save_two_host(tmp_path, (1, 2))
        res, errs = self._restore_both(_host_mgr(tmp_path, 0, 2),
                                       _host_mgr(tmp_path, 1, 2))
        assert not errs, errs
        assert res[0][1] == res[1][1] == 2

    def test_healthy_restore_reads_one_shard_per_host(
            self, tmp_path, monkeypatch):
        """The opening round verifies newest-first and STOPS at the
        first good step: a healthy keep_max-deep dir costs ONE shard
        read+CRC per host per restart, not keep_max of them."""
        import paddle_tpu_torch.io_checkpoint as ioc
        self._save_two_host(tmp_path, (1, 2, 3))
        m0 = _host_mgr(tmp_path, 0, 2)
        m1 = _host_mgr(tmp_path, 1, 2)
        reads = []
        orig = ioc.verify_shard

        def counting(path, **kw):
            reads.append(os.path.basename(path))
            return orig(path, **kw)

        monkeypatch.setattr(ioc, "verify_shard", counting)
        res, errs = self._restore_both(m0, m1)
        assert not errs, errs
        assert res[0][1] == res[1][1] == 3
        assert sorted(reads) == ["ckpt_3.shard0.npz",
                                 "ckpt_3.shard1.npz"]

    def test_lead_announces_round_before_verifying(self, tmp_path):
        """Host 0 publishes the round announcement BEFORE its own CRC
        pass (like the escalated full round always did): followers
        verify in parallel instead of idling their coord_timeout away
        while host 0 reads large shards."""
        import types
        self._save_two_host(tmp_path, (1, 2))
        m0 = _host_mgr(tmp_path, 0, 2)
        m1 = _host_mgr(tmp_path, 1, 2)
        round_up_at_verify = []
        orig = m0._verify_own

        def spying(self, steps, verify, stop_at_first_ok):
            round_up_at_verify.append(
                os.path.exists(self._round_path()))
            return orig(steps, verify,
                        stop_at_first_ok=stop_at_first_ok)

        m0._verify_own = types.MethodType(spying, m0)
        res, errs = self._restore_both(m0, m1)
        assert not errs, errs
        assert res[0][1] == res[1][1] == 2
        assert round_up_at_verify and all(round_up_at_verify)

    def test_verify_own_skips_step_quarantined_under_it(
            self, tmp_path):
        """A step quarantined (or pruned) out from under a host mid-
        protocol — host 0's prior incarnation renamed it *.corrupt
        and died before publishing the decision — must read as
        neither ok nor bad, not crash the follower with EnforceNotMet
        on the vanished meta."""
        self._save_two_host(tmp_path, (1, 2))
        m1 = _host_mgr(tmp_path, 1, 2)
        m1._quarantine(2, "peer incarnation found rot")
        ok, bad, unfit, cache = m1._verify_own([1, 2], True,
                                               stop_at_first_ok=False)
        assert ok == [1]
        assert 2 not in bad         # no positive corruption evidence
        assert 2 not in unfit       # nor a topology refusal
        assert cache is not None and cache[0] == 1

    def test_follower_budget_resets_on_new_round(self, tmp_path):
        """A follower's coord_timeout is a per-ROUND budget, not a
        whole-protocol one: observing a fresh round id (host 0 alive,
        escalating) restarts the clock. Without the reset, first-pass
        time already spent would make a slow escalated full pass a
        deterministic timeout -> gang-restart loop. Here host 0 is
        scripted by hand with gaps each UNDER the budget but totalling
        OVER it — only a reset-on-progress follower survives."""
        import json as _json
        import threading
        import time as _time
        self._save_two_host(tmp_path, (1, 2))
        m0 = _host_mgr(tmp_path, 0, 2)
        m1 = _host_mgr(tmp_path, 1, 2)
        m1.coord_timeout = 2.0
        gap = 1.4

        def host0():
            m0._publish_json(m0._round_path(),
                             {"round": "r1", "mode": "first"},
                             prefix=".restore.r.")
            _time.sleep(gap)
            m0._publish_json(m0._round_path(),
                             {"round": "r2", "mode": "full"},
                             prefix=".restore.r.")
            _time.sleep(gap)
            with open(m0._verdict_path(1)) as f:
                nonce = _json.load(f)["nonce"]
            m0._publish_json(m0._decision_path(),
                             {"step": 2, "nonces": {"1": nonce},
                              "quarantined": []},
                             prefix=".restore.d.")

        t = threading.Thread(target=host0, daemon=True)
        t.start()
        tree, step = m1.restore()       # total wait ~2.8s > 2.0 budget
        t.join(10)
        assert step == 2
        assert float(tree["w"][0]) == 2.0

    def test_no_commonly_verified_step_raises_on_both(self, tmp_path):
        self._save_two_host(tmp_path, (1, 2))
        faults.corrupt_checkpoint(_shard(tmp_path, 2, proc=0), "torn")
        faults.corrupt_checkpoint(_shard(tmp_path, 1, proc=1),
                                  "bitflip")
        res, errs = self._restore_both(_host_mgr(tmp_path, 0, 2),
                                       _host_mgr(tmp_path, 1, 2))
        assert not res, res
        assert isinstance(errs[0], CheckpointCorruptError)
        assert isinstance(errs[1], CheckpointCorruptError)

    def test_missing_peer_verdict_times_out_loudly(self, tmp_path):
        """A peer that never enters restore must produce a loud
        RuntimeError (supervisor restart), not a unilateral pick."""
        self._save_two_host(tmp_path, (1,))
        m0 = _host_mgr(tmp_path, 0, 2)
        m0.coord_timeout = 0.4
        with pytest.raises(RuntimeError, match="coordination"):
            m0.restore()
        m0.close()

    def test_stale_decision_from_dead_incarnation_ignored(
            self, tmp_path):
        """A leftover round + decision pair must not be trusted: the
        decision's nonce echo is not the one this host just published,
        so the host keeps waiting (and times out) instead of restoring
        a stale — possibly since-pruned — step."""
        self._save_two_host(tmp_path, (1, 2))
        m1 = _host_mgr(tmp_path, 1, 2)      # init BEFORE the stale
        m1.coord_timeout = 0.4              # files: past the sweep,
        # the nonce echo is the only defense
        with open(os.path.join(str(tmp_path),
                               ".restore.round.json"), "w") as f:
            json.dump({"round": "stale-round"}, f)
        with open(os.path.join(str(tmp_path),
                               ".restore.decision.json"), "w") as f:
            json.dump({"step": 1, "nonces": {"1": "stale"}}, f)
        with pytest.raises(RuntimeError, match="coordination"):
            m1.restore()
        m1.close()

    def test_stale_peer_verdict_not_trusted_by_host0(self, tmp_path):
        """A dead incarnation's verdict file for host 1 is on disk
        when host 0 enters restore first. Host 0 must NOT decide on
        it (its round tag is stale): it waits, the live host 1
        republishes under the fresh round, and both hosts agree —
        one clean handshake, not a timeout->restart loop."""
        import threading
        import time as _time
        self._save_two_host(tmp_path, (1, 2))
        with open(os.path.join(str(tmp_path),
                               ".restore.h1.json"), "w") as f:
            json.dump({"round": "dead-round", "nonce": "dead",
                       "ok": [1], "bad": {}}, f)   # stale: only step 1
        m0 = _host_mgr(tmp_path, 0, 2)
        m0.coord_timeout = 30.0
        res, errs = {}, {}

        def run0():
            try:
                res[0] = m0.restore()
            except Exception as e:      # noqa: BLE001 — re-asserted
                errs[0] = e

        t = threading.Thread(target=run0, daemon=True)
        t.start()
        _time.sleep(0.5)        # host 0 must still be WAITING, not
        assert 0 not in res     # returned with the stale verdict's
        assert 0 not in errs    # step-1 pick
        m1 = _host_mgr(tmp_path, 1, 2)  # live host 1 arrives late;
        m1.coord_timeout = 30.0         # its init swept the stale
        res[1] = m1.restore()           # verdict, fresh one republishes
        t.join(30)
        assert not t.is_alive() and not errs, errs
        assert res[0][1] == res[1][1] == 2
        m0.close()
        m1.close()

    def test_quarantine_renames_every_hosts_shard(self, tmp_path):
        """Single-host walk-back over a dir holding a multi-host step:
        quarantining must rename ALL shardP files, not just its own
        (orphan shards of a meta-less step are invisible to _prune)."""
        import shutil
        mgr = _mgr(tmp_path, keep_max=10)
        for s in (1, 2, 3):
            mgr.save(s, _state(s))
        mgr.close()
        shutil.copyfile(_shard(tmp_path, 3, 0), _shard(tmp_path, 3, 1))
        with open(_meta(tmp_path, 3), "w") as f:
            json.dump({"step": 3, "nproc": 2}, f)
        faults.corrupt_checkpoint(_shard(tmp_path, 3, 0), "bitflip")
        mgr2 = _mgr(tmp_path)
        tree, step = mgr2.restore()
        assert step == 2
        for p in (0, 1):
            assert os.path.exists(_shard(tmp_path, 3, p) + ".corrupt")
            assert not os.path.exists(_shard(tmp_path, 3, p))
        mgr2.close()


class TestDataStatePlumbing:
    def test_data_state_in_shard_and_meta(self, tmp_path):
        mgr = _mgr(tmp_path)
        ds = {"epoch": 2, "records_consumed": 640}
        mgr.save(7, _state(7), data_state=ds)
        assert mgr.restore_data_state(7) == ds
        with open(_meta(tmp_path, 7)) as f:
            assert json.load(f)["data_state"] == ds
        mgr.close()
        # a fresh manager (restarted process) reads it too
        m2 = _mgr(tmp_path)
        tree, step = m2.restore()
        assert m2.restore_data_state(step) == ds
        m2.close()

    def test_no_data_state_returns_none(self, tmp_path):
        mgr = _mgr(tmp_path)
        mgr.save(1, _state(1))
        assert mgr.restore_data_state(1) is None
        with open(_meta(tmp_path, 1)) as f:
            assert "data_state" not in json.load(f)
        mgr.close()


class TestEvenInterval:
    def test_partitions_exactly(self):
        for total in (0, 1, 7, 10, 64):
            for parts in (1, 2, 3, 4, 7):
                ivs = [even_interval(total, parts, i)
                       for i in range(parts)]
                assert ivs[0][0] == 0 and ivs[-1][1] == total
                for (a, b), (c, d) in zip(ivs, ivs[1:]):
                    assert b == c           # contiguous, disjoint
                sizes = [b - a for a, b in ivs]
                assert max(sizes) - min(sizes) <= 1

    def test_matches_array_split(self):
        for total, parts in ((10, 3), (7, 4), (2, 4)):
            arr = np.arange(total)
            for i, piece in enumerate(np.array_split(arr, parts)):
                lo, hi = even_interval(total, parts, i)
                assert np.array_equal(arr[lo:hi], piece)


class TestSaveAxes:
    def test_array_info_recorded(self, tmp_path):
        m = _rmgr(tmp_path, 0, 1)
        m.save(1, {"w": np.zeros((4, 3)), "b": np.ones(2), "n": 5},
               axes={"w": 0, "b": None, "n": None})
        manifest, _ = verify_shard(_shard(tmp_path, 1))
        info = manifest["array_info"]
        by_shape = {tuple(v["shape"]): v for v in info.values()}
        assert by_shape[(4, 3)]["axis"] == 0
        assert by_shape[(2,)]["axis"] is None
        assert by_shape[(4, 3)]["dtype"] == "float64"
        m.close()

    def test_axes_default_all_replicated(self, tmp_path):
        m = _rmgr(tmp_path, 0, 1)
        m.save(1, {"w": np.zeros(3)})
        manifest, _ = verify_shard(_shard(tmp_path, 1))
        assert all(v["axis"] is None
                   for v in manifest["array_info"].values())
        m.close()

    def test_axis_out_of_range_rejected(self, tmp_path):
        m = _rmgr(tmp_path, 0, 1)
        with pytest.raises(ValueError, match="out of range"):
            m.save(1, {"w": np.zeros(3)}, axes={"w": 1})
        m.close()

    def test_bool_axis_rejected(self, tmp_path):
        m = _rmgr(tmp_path, 0, 1)
        with pytest.raises(ValueError, match="shard axis"):
            m.save(1, {"w": np.zeros(3)}, axes={"w": True})
        m.close()

    def test_mismatched_axes_tree_rejected(self, tmp_path):
        m = _rmgr(tmp_path, 0, 1)
        with pytest.raises(ValueError, match="does not match"):
            m.save(1, {"w": np.zeros(3)}, axes={"wrong_key": 0})
        m.close()


class TestReshardRestore:
    def test_two_hosts_to_one(self, tmp_path):
        _save_all_hosts(tmp_path, 3, 2)
        m = _rmgr(tmp_path, 0, 1)
        tree, step = m.restore()
        assert step == 3
        assert np.array_equal(np.asarray(tree["w"]),
                              np.arange(10.0) + 3)
        assert np.asarray(tree["opt"][0]).shape == (3, 2)
        assert tree["opt"][1] == ("m", 3.0)     # tuple survives
        assert tree["n"] == 7
        m.close()

    def test_two_hosts_to_four(self, tmp_path):
        _save_all_hosts(tmp_path, 2, 2)
        for r in range(4):
            m = _rmgr(tmp_path, r, 4)
            tree, _ = m.restore(step=2)
            lo, hi = even_interval(10, 4, r)
            assert np.array_equal(np.asarray(tree["w"]),
                                  np.arange(10.0)[lo:hi] + 2)
            # replicated leaves identical on every reader
            assert np.array_equal(np.asarray(tree["opt"][0]),
                                  np.full((3, 2), 2.0))
            m.close()

    def test_uneven_divisors_three_to_two(self, tmp_path):
        # writers hold 4/3/3 rows; readers must get 5/5
        _save_all_hosts(tmp_path, 1, 3)
        for r in range(2):
            m = _rmgr(tmp_path, r, 2)
            tree, _ = m.restore(step=1)
            lo, hi = even_interval(10, 2, r)
            assert np.array_equal(np.asarray(tree["w"]),
                                  np.arange(10.0)[lo:hi] + 1)
            m.close()

    def test_more_readers_than_rows_empty_slice(self, tmp_path):
        def small(p, nproc, step):
            lo, hi = even_interval(2, nproc, p)
            return {"w": np.arange(2.0).reshape(2, 1)[lo:hi]}

        _save_all_hosts(tmp_path, 1, 2, state_fn=small,
                        axes={"w": 0})
        m = _rmgr(tmp_path, 3, 4)        # rows 0,1 went to readers 0,1
        tree, _ = m.restore(step=1)
        w = np.asarray(tree["w"])
        # the port keeps the file's dtype (the JAX package's jnp.asarray
        # downcasts float64 to float32 without x64); the shape keeps the
        # trailing dims
        assert w.shape == (0, 1) and w.dtype == np.float64
        m.close()

    def test_one_host_to_many_slices_sharded_leaves(self, tmp_path):
        # W=1 with array_info: sharded leaves must SLICE, not replicate
        _save_all_hosts(tmp_path, 5, 1)
        m = _rmgr(tmp_path, 1, 2)
        tree, _ = m.restore(step=5)
        lo, hi = even_interval(10, 2, 1)
        assert np.array_equal(np.asarray(tree["w"]),
                              np.arange(10.0)[lo:hi] + 5)
        m.close()

    def test_fixed_world_pays_no_reshard(self, tmp_path):
        """W == R never touches the reshard path (acceptance: the
        fast path is unchanged)."""
        _save_all_hosts(tmp_path, 1, 2)
        before = REGISTRY.get("reshard_restores_total").value()
        calls = []
        orig = CheckpointManager._read_shard_manifest

        def spy(self, path):
            calls.append(path)
            return orig(self, path)

        CheckpointManager._read_shard_manifest = spy
        try:
            m = _rmgr(tmp_path, 0, 2)
            tree, _ = m.restore(step=1)
            m.close()
        finally:
            CheckpointManager._read_shard_manifest = orig
        assert not calls                # no manifest pre-scan
        assert REGISTRY.get("reshard_restores_total").value() == before
        lo, hi = even_interval(10, 2, 0)
        assert np.array_equal(np.asarray(tree["w"]),
                              np.arange(10.0)[lo:hi] + 1)

    def test_reshard_metric_and_log(self, tmp_path, caplog):
        _save_all_hosts(tmp_path, 1, 2)
        before = REGISTRY.get("reshard_restores_total").value()
        with caplog.at_level(logging.WARNING, "paddle_tpu.checkpoint"):
            m = _rmgr(tmp_path, 0, 1)
            m.restore()
            m.close()
        assert REGISTRY.get("reshard_restores_total").value() \
            == before + 1
        assert "written nproc=2 -> read nproc=1" in caplog.text

    def test_corrupt_shard_under_new_topology_walks_back(self,
                                                         tmp_path):
        """The acceptance case: the newest step's shard 1 is rotted;
        a 1-rank restore of the 2-host dir must quarantine the WHOLE
        step and land on the resharded previous one."""
        _save_all_hosts(tmp_path, 1, 2)
        _save_all_hosts(tmp_path, 2, 2)
        faults.corrupt_checkpoint(_shard(tmp_path, 2, proc=1),
                                  "bitflip")
        before = REGISTRY.get("corrupt_checkpoints_total").value()
        m = _rmgr(tmp_path, 0, 1)
        tree, step = m.restore()
        assert step == 1
        assert np.array_equal(np.asarray(tree["w"]),
                              np.arange(10.0) + 1)
        # both hosts' shards + meta quarantined, not just the bad one
        assert os.path.exists(_shard(tmp_path, 2, 0) + ".corrupt")
        assert os.path.exists(_shard(tmp_path, 2, 1) + ".corrupt")
        assert REGISTRY.get("corrupt_checkpoints_total").value() \
            == before + 1
        m.close()

    def test_elastic_prune_collects_old_topology_shards(self, tmp_path):
        """After a shrink, pruning must collect the larger-world steps'
        higher-numbered shards too (scan-based, not range(nproc))."""
        for s in (1, 2):
            _save_all_hosts(tmp_path, s, 2)
        m = _rmgr(tmp_path, 0, 1, keep_max=1)
        m.restore()                     # resharded from step 2
        m.save(3, {"w": np.arange(10.0) + 3, "opt": [np.zeros((3, 2)),
                   ("m", 3.0)], "n": 7}, axes=_AXES)
        m.save(4, {"w": np.arange(10.0) + 4, "opt": [np.zeros((3, 2)),
                   ("m", 4.0)], "n": 7}, axes=_AXES)
        m.close()
        leftover = [f for f in os.listdir(str(tmp_path))
                    if f.startswith("ckpt_1.") or f.startswith("ckpt_2.")]
        # step 2 survives only because it was the last VERIFIED step;
        # step 1 (both hosts' shards + meta) must be fully collected
        assert not [f for f in leftover if f.startswith("ckpt_1.")], \
            leftover


class TestTopologyError:
    def test_legacy_multi_host_names_both_nprocs(self, tmp_path):
        _save_all_hosts(tmp_path, 1, 2)
        for p in range(2):
            _strip_array_info(_shard(tmp_path, 1, p))
        m = _rmgr(tmp_path, 0, 1)
        with pytest.raises(CheckpointTopologyError) as ei:
            m.restore()
        msg = str(ei.value)
        assert "nproc=2" in msg and "nproc=1" in msg
        assert "array_info" in msg
        # the files are HEALTHY: nothing quarantined
        assert os.path.exists(_shard(tmp_path, 1, 0))
        assert not os.path.exists(_shard(tmp_path, 1, 0) + ".corrupt")
        m.close()

    def test_legacy_single_host_still_replicates(self, tmp_path):
        """W==1 legacy keeps today's replicated fallback at any R."""
        m0 = _rmgr(tmp_path, 0, 1)
        m0.save(1, {"w": np.arange(4.0)})
        m0.close()
        _strip_array_info(_shard(tmp_path, 1, 0))
        m = _rmgr(tmp_path, 1, 2)
        tree, _ = m.restore(step=1)
        assert np.array_equal(np.asarray(tree["w"]), np.arange(4.0))
        m.close()

    def test_newer_legacy_not_walked_past(self, tmp_path):
        """A healthy-but-unfit newest step must raise, not silently
        fall back to older resharded state."""
        _save_all_hosts(tmp_path, 1, 2)
        _save_all_hosts(tmp_path, 2, 2)
        for p in range(2):
            _strip_array_info(_shard(tmp_path, 2, p))
        m = _rmgr(tmp_path, 0, 1)
        with pytest.raises(CheckpointTopologyError):
            m.restore()
        m.close()

    def test_unreplicated_replicated_leaf_refused(self, tmp_path):
        """Review fix: a leaf annotated replicated (the axes=None
        default) whose content actually DIFFERS across writers (e.g.
        per-host RNG keys) must refuse the reshard — collapsing it to
        one writer's copy would silently restore wrong state. The
        recorded per-array CRCs prove the divergence from the
        manifests alone."""

        def per_host(p, nproc, step):
            lo, hi = even_interval(10, nproc, p)
            return {"w": np.arange(10.0)[lo:hi] + step,
                    "rng": np.full(2, float(p))}   # per-host content!

        _save_all_hosts(tmp_path, 1, 2, state_fn=per_host,
                        axes={"w": 0, "rng": None})
        m = _rmgr(tmp_path, 0, 1)
        with pytest.raises(CheckpointTopologyError,
                           match="annotated replicated"):
            m.restore(step=1)
        # healthy files: no quarantine
        assert os.path.exists(_shard(tmp_path, 1, 0))
        m.close()

    def test_identical_replicated_leaf_passes_crc_check(self, tmp_path):
        _save_all_hosts(tmp_path, 1, 2)     # opt[0] replicated, equal
        m = _rmgr(tmp_path, 0, 1)
        tree, _ = m.restore(step=1)
        assert np.array_equal(np.asarray(tree["opt"][0]),
                              np.full((3, 2), 1.0))
        m.close()

    def test_fsck_mirrors_replicated_divergence(self, tmp_path):
        """Review fix: fsck --nproc must not report 'restorable: yes'
        for a step restore() will refuse — the cross-writer checks run
        offline from the manifests fsck already read."""
        sys.path.insert(0, os.path.join(REPO, "tools"))
        import fsck_checkpoint

        def per_host(p, nproc, step):
            lo, hi = even_interval(10, nproc, p)
            return {"w": np.arange(10.0)[lo:hi] + step,
                    "rng": np.full(2, float(p))}   # per-host content

        _save_all_hosts(tmp_path, 1, 2, state_fn=per_host,
                        axes={"w": 0, "rng": None})
        steps, _extras = fsck_checkpoint.fsck_dir(str(tmp_path))
        rec = steps[0]
        assert rec["status"] == "ok" and not rec["reshardable"]
        fits, why = fsck_checkpoint.restorable_at(rec, 4)
        assert not fits and "replicated" in why
        # at the WRITTEN size it restores fine (no reshard involved)
        fits, _ = fsck_checkpoint.restorable_at(rec, 2)
        assert fits

    def test_fsck_nproc_flags_newest_unfit_step(self, tmp_path,
                                                capsys):
        """Review fix: per-step 'yes' lines are not the whole story —
        restore() refuses when a healthy step NEWER than the best
        fitting one cannot reshard, and fsck --nproc must exit 1 and
        say so instead of promising a restore that won't happen."""
        sys.path.insert(0, os.path.join(REPO, "tools"))
        import fsck_checkpoint
        _save_all_hosts(tmp_path, 1, 2)             # fit at nproc=1
        _save_all_hosts(tmp_path, 2, 2)             # newest: made unfit
        for p in range(2):
            _strip_array_info(_shard(tmp_path, 2, p))
        rc = fsck_checkpoint.main([str(tmp_path), "--nproc", "1"])
        out = capsys.readouterr().out
        assert rc == 1
        assert "newest healthy step 2 is NOT restorable" in out
        # and the manager agrees: restore at nproc=1 refuses
        m = _rmgr(tmp_path, 0, 1)
        with pytest.raises(CheckpointTopologyError):
            m.restore()
        m.close()

    def test_diverging_axis_annotations_refused(self, tmp_path):
        """Review fix: writers that annotated DIFFERENT shard axes for
        one array (stale config on one host) must refuse — planning
        from one writer's annotation would concat a full copy as if it
        were a slice, restoring rank-dependent wrong state."""
        m1 = _rmgr(tmp_path, 1, 2)
        m1.save(1, {"w": np.arange(10.0)}, axes={"w": None})  # full
        m1.close()
        m0 = _rmgr(tmp_path, 0, 2)
        m0.save(1, {"w": np.arange(5.0)}, axes={"w": 0})      # slice
        m0.close()
        m = _rmgr(tmp_path, 0, 1)
        with pytest.raises(CheckpointTopologyError,
                           match="disagree on its shard axis"):
            m.restore(step=1)
        m.close()

    def test_diverging_trees_rejected(self, tmp_path):
        m1 = _rmgr(tmp_path, 1, 2)
        m1.save(1, {"w": np.zeros(3), "extra": np.ones(2)},
                axes={"w": 0, "extra": None})
        m1.close()
        m0 = _rmgr(tmp_path, 0, 2)
        m0.save(1, {"w": np.zeros(3)}, axes={"w": 0})
        m0.close()
        m = _rmgr(tmp_path, 0, 1)
        with pytest.raises(CheckpointTopologyError,
                           match="tree structure"):
            m.restore(step=1)
        m.close()

    def test_explicit_step_corrupt_still_raises_corrupt(self, tmp_path):
        _save_all_hosts(tmp_path, 1, 2)
        faults.corrupt_checkpoint(_shard(tmp_path, 1, 1), "bitflip")
        m = _rmgr(tmp_path, 0, 1)
        with pytest.raises(CheckpointCorruptError):
            m.restore(step=1)
        m.close()


class TestCoordinatedReshard:
    """The multi-host collective restore across a topology change:
    R readers coordinate over a dir written by W != R hosts."""

    def _restore_all(self, mgrs, timeout=30.0):
        res, errs = {}, {}
        for m in mgrs:
            m.coord_timeout = timeout

        def run(i, m):
            try:
                res[i] = m.restore()
            except Exception as e:      # noqa: BLE001 — re-asserted
                errs[i] = e

        threads = [threading.Thread(target=run, args=(i, m),
                                    daemon=True)
                   for i, m in enumerate(mgrs[1:], 1)]
        for t in threads:
            t.start()
        run(0, mgrs[0])
        for t in threads:
            t.join(timeout)
            assert not t.is_alive(), "a reader hung in restore"
        return res, errs

    def test_four_readers_of_two_writers(self, tmp_path):
        _save_all_hosts(tmp_path, 2, 2)
        res, errs = self._restore_all(
            [_rmgr(tmp_path, r, 4) for r in range(4)])
        assert not errs, errs
        full = np.concatenate(
            [np.asarray(res[r][0]["w"]) for r in range(4)])
        assert np.array_equal(full, np.arange(10.0) + 2)
        assert all(res[r][1] == 2 for r in range(4))

    def test_two_readers_of_four_writers(self, tmp_path):
        _save_all_hosts(tmp_path, 3, 4)
        res, errs = self._restore_all(
            [_rmgr(tmp_path, r, 2) for r in range(2)])
        assert not errs, errs
        full = np.concatenate(
            [np.asarray(res[r][0]["w"]) for r in range(2)])
        assert np.array_equal(full, np.arange(10.0) + 3)

    def test_reshard_reads_each_shard_once_per_reader(self, tmp_path):
        """Review fix: the verification pass pre-loads the reshard and
        the agreed restore reuses it — no writer shard is fully read
        (and CRC'd) twice by one reader on the healthy elastic path."""
        import paddle_tpu_torch.io_checkpoint as ioc
        _save_all_hosts(tmp_path, 3, 4)
        seen = {}
        orig = ioc.verify_shard

        def spy(path, *a, **kw):
            key = (threading.get_ident(), os.path.basename(path))
            seen[key] = seen.get(key, 0) + 1
            return orig(path, *a, **kw)

        ioc.verify_shard = spy
        try:
            res, errs = self._restore_all(
                [_rmgr(tmp_path, r, 2) for r in range(2)])
        finally:
            ioc.verify_shard = orig
        assert not errs, errs
        dup = {k: n for k, n in seen.items() if n > 1}
        assert not dup, dup

    def test_corrupt_writer_shard_walks_all_readers_back(self,
                                                         tmp_path):
        _save_all_hosts(tmp_path, 1, 2)
        _save_all_hosts(tmp_path, 2, 2)
        faults.corrupt_checkpoint(_shard(tmp_path, 2, 1), "bitflip")
        res, errs = self._restore_all(
            [_rmgr(tmp_path, r, 4) for r in range(4)])
        assert not errs, errs
        assert all(res[r][1] == 1 for r in range(4))
        assert os.path.exists(_shard(tmp_path, 2, 0) + ".corrupt")

    def test_legacy_raises_topology_error_on_every_reader(self,
                                                          tmp_path):
        _save_all_hosts(tmp_path, 1, 2)
        for p in range(2):
            _strip_array_info(_shard(tmp_path, 1, p))
        res, errs = self._restore_all(
            [_rmgr(tmp_path, r, 4) for r in range(4)])
        assert not res, res
        assert set(errs) == {0, 1, 2, 3}
        assert all(isinstance(e, CheckpointTopologyError)
                   for e in errs.values()), errs
        # precise refusal, not a protocol timeout
        assert "nproc=2" in str(errs[0])


class TestDataStateRescale:
    def _dp_state(self, rank, world):
        return {"version": 1, "epoch": 0, "file_index": 0,
                "offset": 120, "epoch_records": 12,
                "records_consumed": 12, "seed": 5, "shuffle_buffer": 8,
                "nfiles": 1, "files": [["a.txt", 200]],
                "dp": {"world_size": world, "rank": rank,
                       "global_batch": 4}}

    def test_merge_equal_cursors(self):
        fr = merge_rank_states([self._dp_state(0, 2),
                                self._dp_state(1, 2)])
        assert fr["records_consumed"] == 12
        assert fr["dp"] == {"world_size": 2, "global_batch": 4}

    def test_merge_divergent_cursors_refused(self):
        a, b = self._dp_state(0, 2), self._dp_state(1, 2)
        b["records_consumed"] = 16
        with pytest.raises(ValueError, match="diverge"):
            merge_rank_states([a, b])

    def test_restore_data_state_merges_frontier(self, tmp_path):
        states = [self._dp_state(p, 2) for p in range(2)]
        _save_all_hosts(tmp_path, 1, 2, data_states=states)
        m = _rmgr(tmp_path, 0, 1)
        m.restore()
        ds = m.restore_data_state(1)
        assert ds["records_consumed"] == 12
        assert "rank" not in ds["dp"]
        m.close()

    def test_restore_divergent_cursors_topology_error(self, tmp_path):
        states = [self._dp_state(p, 2) for p in range(2)]
        states[1]["records_consumed"] = 99
        _save_all_hosts(tmp_path, 1, 2, data_states=states)
        m = _rmgr(tmp_path, 0, 1)
        m.restore()     # model state reshards fine...
        with pytest.raises(CheckpointTopologyError, match="cursor"):
            m.restore_data_state(1)     # ...the cursor refuses
        m.close()

    def test_partial_data_state_topology_error(self, tmp_path):
        states = [self._dp_state(0, 2), None]
        _save_all_hosts(tmp_path, 1, 2, data_states=states)
        m = _rmgr(tmp_path, 0, 1)
        m.restore()
        with pytest.raises(CheckpointTopologyError, match="partial"):
            m.restore_data_state(1)
        m.close()

    def test_same_topology_keeps_own_cursor(self, tmp_path):
        states = [self._dp_state(p, 2) for p in range(2)]
        _save_all_hosts(tmp_path, 1, 2, data_states=states)
        m = _rmgr(tmp_path, 1, 2)
        ds = m.restore_data_state(1)
        assert ds["dp"]["rank"] == 1    # own shard's cursor, unmerged


def test_two_writers_three_readers_uneven(tmp_path):
    """2 writers -> 3 readers, 10 rows: the readers' extents are 4, 3 and
    3 (``np.array_split``), each straddling the writers' 5 + 5 where it
    must; the coordinated round on threads, as the JAX tests run it."""
    _save_all_hosts(tmp_path, 4, 2)
    res, errs = TestCoordinatedReshard()._restore_all(
        [_rmgr(tmp_path, r, 3) for r in range(3)])
    assert not errs, errs
    parts = [np.asarray(res[r][0]["w"]) for r in range(3)]
    assert [len(p) for p in parts] == [4, 3, 3]
    assert np.array_equal(np.concatenate(parts), np.arange(10.0) + 4)
    for r in range(3):
        assert res[r][1] == 4
        np.testing.assert_array_equal(res[r][0]["opt"][0],
                                      np.full((3, 2), 4.0))
        assert res[r][0]["opt"][1] == ("m", 4.0) and res[r][0]["n"] == 7


# ---------------------------------------------------------------------------
# checkpoints across the two packages, bitwise
# ---------------------------------------------------------------------------
def _np_tree():
    rng = np.random.RandomState(0)
    return {"params": {"w": rng.randn(5, 3).astype(np.float32),
                       "b": rng.randn(3).astype(np.float16),
                       "table": rng.randint(0, 9, (4, 2)).astype(np.int32)},
            "opt": [np.zeros(3, np.float32), (np.ones(2, np.uint8), "m")],
            "step": np.asarray(3, np.int32), "mask": rng.rand(6) > 0.5,
            "n": 7, "lr": 0.25, "name": "bert", "none": None}


_NP_AXES = {"params": {"w": 0, "b": None, "table": None},
            "opt": [None, (None, None)], "step": None, "mask": None,
            "n": None, "lr": None, "name": None, "none": None}


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_torch(v) for v in tree)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy())
    return tree


def _assert_same(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    elif isinstance(want, (np.ndarray, torch.Tensor)):
        g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        w = want.numpy() if isinstance(want, torch.Tensor) else want
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()
    else:
        assert got == want


def _manifest(path):
    with np.load(path, allow_pickle=False) as blob:
        return json.loads(bytes(blob["__manifest__"].tobytes()).decode())


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    from paddle_tpu.io_checkpoint import CheckpointManager as JManager
    tree = _np_tree()
    jm = JManager(str(tmp_path), async_save=False, keep_max=5)
    jm.save(3, tree, data_state={"version": 2, "consumed": 11},
            axes=_NP_AXES)
    jm.close()
    m = CheckpointManager(str(tmp_path))
    got, step = m.restore(device="cpu")
    assert step == 3
    _assert_same(got, tree)
    assert m.restore_data_state(3) == {"version": 2, "consumed": 11}
    manifest, arrays = verify_shard(_shard(tmp_path, 3))
    assert manifest["array_info"]["a0"] == {"shape": [5, 3],
                                            "dtype": "float32", "axis": 0}
    assert set(manifest["integrity"]["arrays"]) == set(arrays)
    m.close()


def test_port_checkpoint_restores_in_jax(tmp_path):
    """The port's shard and meta are the JAX package's byte for byte in
    every field but the meta's wall time: the same numpy tree saved by
    both managers gives equal manifests (integrity block, array_info,
    data_state), and the JAX manager restores the port's tensors."""
    from paddle_tpu.io_checkpoint import CheckpointManager as JManager
    from paddle_tpu.io_checkpoint import verify_shard as jverify
    tree = _np_tree()
    ds = {"version": 2, "consumed": 11}
    pdir, jdir = tmp_path / "port", tmp_path / "jax"
    m = CheckpointManager(str(pdir), keep_max=5)
    m.save(3, _as_torch(tree), data_state=ds, axes=_NP_AXES)
    m.close()
    jm = JManager(str(jdir), async_save=False, keep_max=5)
    jm.save(3, tree, data_state=ds, axes=_NP_AXES)
    jm.close()
    assert _manifest(_shard(pdir, 3)) == _manifest(_shard(jdir, 3))
    meta_p, meta_j = (json.load(open(_meta(d, 3))) for d in (pdir, jdir))
    meta_p.pop("time"), meta_j.pop("time")
    assert meta_p == meta_j
    manifest, arrays = jverify(_shard(pdir, 3))
    assert "integrity" in manifest
    jm = JManager(str(pdir))
    got, step = jm.restore()
    assert step == 3 and jm.restore_data_state(3) == ds
    # jnp keeps every dtype of this tree (no 64-bit leaf)
    _assert_same({k: got[k] for k in ("params", "opt", "mask", "step")},
                 {k: tree[k] for k in ("params", "opt", "mask", "step")})
    jm.close()


def test_fsck_accepts_a_directory_the_port_wrote(tmp_path):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import fsck_checkpoint
    m = CheckpointManager(str(tmp_path), keep_max=5)
    for s in (1, 2):
        m.save(s, _as_torch(_np_tree()), axes=_NP_AXES)
    m.close()
    steps, extras = fsck_checkpoint.fsck_dir(str(tmp_path))
    assert [(r["step"], r["status"], r["reshardable"]) for r in steps] == \
        [(1, "ok", True), (2, "ok", True)]
    assert extras == {"quarantined": [], "tmp": [], "orphan_shards": []}
    faults.corrupt_checkpoint(_shard(tmp_path, 2), "bitflip")
    steps, _ = fsck_checkpoint.fsck_dir(str(tmp_path))
    assert [r["status"] for r in steps] == ["ok", "corrupt"]


def test_bf16_leaf_is_refused_by_both_packages(tmp_path):
    import jax.numpy as jnp
    from paddle_tpu.io_checkpoint import CheckpointManager as JManager
    jm = JManager(str(tmp_path / "jax"), async_save=False)
    with pytest.raises(ValueError):
        jm.save(1, {"w": jnp.ones((2,), jnp.bfloat16)})
    jm.close()
    for async_save in (False, True):
        m = CheckpointManager(str(tmp_path / f"port{async_save}"),
                              async_save=async_save)
        with pytest.raises(ValueError, match=r"leaf /moments\[1\] is bfloat16"):
            m.save(1, {"moments": [torch.ones(2),
                               torch.ones(2, dtype=torch.bfloat16)]})
        m.close()
        assert m.latest_step() is None
    with pytest.raises(ValueError, match="bfloat16"):
        ioc.publish_npz(str(tmp_path / "a.npz"),
                        {"w": torch.ones(2, dtype=torch.bfloat16)})


# ---------------------------------------------------------------------------
# the snapshot holds the step's values while the state is updated in place
# ---------------------------------------------------------------------------
def _mutate_all(tree):
    for t in _leaves(tree):
        if t.dtype == torch.bool:
            t.logical_not_()
        else:
            t.add_(1)


def _leaves(tree):
    from paddle_tpu_torch.core.tree import tensors
    return tensors(tree)


@pytest.mark.parametrize("async_save", [True, False])
def test_save_then_in_place_update_restores_the_saved_values(tmp_path,
                                                             async_save):
    gen = torch.Generator().manual_seed(0)
    tree = {"big": torch.randn(1 << 22, generator=gen),
            "w": torch.randn(30, 7, generator=gen),
            "h": torch.randn(5, generator=gen).half(),
            "ids": torch.randint(0, 9, (11,), generator=gen),
            "i32": torch.arange(4, dtype=torch.int32),
            "mask": torch.rand(9, generator=gen) > 0.5,
            "step": torch.tensor(7), "opt": [torch.zeros(3), (torch.ones(2),
                                                              "m")], "n": 1}
    before = ioc.map_tensors(lambda t: t.clone(), tree)
    m = CheckpointManager(str(tmp_path), async_save=async_save)
    m.save(1, tree)
    _mutate_all(tree)               # every leaf at once, before the write
    m.wait()
    got, _ = m.restore(device="cpu")
    _assert_same(got, before)
    assert not torch.equal(tree["big"], before["big"])
    m.close()


def test_save_copies_numpy_leaves(tmp_path):
    tree = {"w": np.arange(1 << 20, dtype=np.float32)}
    m = CheckpointManager(str(tmp_path))
    m.save(1, tree)
    tree["w"] += 1
    m.wait()
    got, _ = m.restore(device="cpu")
    np.testing.assert_array_equal(got["w"].numpy(),
                                  np.arange(1 << 20, dtype=np.float32))
    m.close()


# ---------------------------------------------------------------------------
# auto_checkpoint on bert_tiny: against the JAX package, and a crash + resume
# against the uninterrupted run, the data cursor from FileDataLoader
# ---------------------------------------------------------------------------
AC_LR, AC_STEPS, AC_EVERY, AC_B, AC_S = 1e-3, 6, 2, 2, 32


@pytest.fixture(scope="module")
def mlm_files(tmp_path_factory):
    sys.path.insert(0, REPO)
    import chip_smoke
    from paddle_tpu_torch.dataio import text_corpus
    d = str(tmp_path_factory.mktemp("mlm"))
    files, _, _ = chip_smoke.mlm_record_files(
        text_corpus, REPO, d, 512, 40, AC_S, 2, 3)
    return files


def _loader(pkg, files):
    import chip_smoke
    if pkg == "jax":
        from paddle_tpu.dataio import FileDataLoader
    else:
        from paddle_tpu_torch.dataio import FileDataLoader
    return FileDataLoader(files, chip_smoke.parse_mlm_record, AC_B,
                          shuffle_buffer=8, seed=3, mode="lines",
                          device_put=False, stateful=True)


def _step_fn(train_step, loader, losses, crash_at=None):
    it = [None]

    def step_fn(step, st):
        if step == crash_at:
            raise RuntimeError("killed")
        if it[0] is None:
            it[0] = iter(loader)
        _rid, ids, labels, w = next(it[0])
        loss, p, s = train_step(st["params"], st["opt"], {
            "input_ids": ids, "labels": labels,
            "weights": w.astype(np.float32)})
        losses[step] = float(loss)
        return {"params": p, "opt": s}
    return step_fn


@pytest.fixture(scope="module")
def jax_bert_run(mlm_files, tmp_path_factory):
    """The JAX package's auto_checkpoint over bert_tiny (its plain
    reference path, jitted): initial params and Adam state, per-step
    losses and the final params, as numpy."""
    import jax
    import paddle_tpu as jpt
    from paddle_tpu.io_checkpoint import auto_checkpoint as jauto
    from paddle_tpu.models import bert as jbert
    from paddle_tpu.parallel.mesh import MeshConfig, make_mesh, mesh_guard
    cfg = jbert.bert_tiny(vocab_size=512, dtype=np.float32)
    mesh = make_mesh(MeshConfig(data=1, model=1, seq=1, pipe=1))
    with mesh_guard(mesh):
        init_fn, train_step = jbert.make_train_step(
            cfg, jpt.optimizer.Adam(learning_rate=AC_LR), mesh)
        params, state = init_fn(jax.random.PRNGKey(0))
        p0 = jax.tree.map(lambda a: np.array(a), params)
        s0 = jax.tree.map(lambda a: np.array(a), state)
        losses = {}
        loader = _loader("jax", mlm_files)
        out = jauto(str(tmp_path_factory.mktemp("jax_ck")),
                    lambda: {"params": params, "opt": state}, AC_STEPS,
                    _step_fn(train_step, loader, losses),
                    save_interval_steps=AC_EVERY, data_state=loader)
        final = jax.tree.map(lambda a: np.array(a), out["params"])
    return p0, s0, [losses[i] for i in range(AC_STEPS)], final


def _port_auto(dirname, p0, s0, files, losses, crash_at=None):
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models import bert as tbert
    cfg = tbert.bert_tiny(vocab_size=512, dtype=torch.float32)
    opt = topt.Adam(learning_rate=AC_LR)
    _, train_step = tbert.make_train_step(cfg, opt, device="cpu")

    def init():
        params = tbert.params_from_numpy(p0, cfg, device="cpu")
        return {"params": params, "opt": opt.state_from_numpy(s0, params)}

    loader = _loader("port", files)
    return auto_checkpoint(
        dirname, init, AC_STEPS,
        _step_fn(train_step, loader, losses, crash_at=crash_at),
        save_interval_steps=AC_EVERY, data_state=loader, device="cpu")


def _flat_np(tree, prefix=""):
    if isinstance(tree, (dict, list, tuple)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for k, v in items:
            out.update(_flat_np(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree.numpy() if isinstance(
        tree, torch.Tensor) else tree)}


def test_auto_checkpoint_bert_tiny_matches_jax(jax_bert_run, mlm_files,
                                               tmp_path):
    """6 Adam steps of bert_tiny (fp32) under each package's
    auto_checkpoint, a save every 2 steps, each fed by its own
    FileDataLoader (the data_state) over the same record files from the
    same initial weights: losses within 1e-5 relative (observed 7.8e-8).
    Parameters: each within 1e-5 of its leaf's largest magnitude, but no
    tighter than a hundredth of one Adam step (0.01 * lr): Adam's
    sign-like update on a near-zero gradient turns the two frameworks'
    summation orders into an update difference (observed up to 2.1e-6 on
    one element, 0.0021 lr, depending on the CPU's thread count; the
    leaves that start at zero hold only six steps, up to 2.8e-5 of their
    largest value). Each leaf's update (final minus initial) is held to
    JAX's within 1e-4 relative norm error (observed at most 1.1e-5),
    where an update of half strength reads 0.5."""
    p0, s0, jlosses, jfinal = jax_bert_run
    losses = {}
    out = _port_auto(str(tmp_path), p0, s0, mlm_files, losses)
    tl = [losses[i] for i in range(AC_STEPS)]
    np.testing.assert_allclose(tl, jlosses, rtol=1e-5, atol=0)
    assert tl[-1] < tl[0]
    got, want = _flat_np(out["params"]), _flat_np(jfinal)
    start = _flat_np(p0)
    assert got.keys() == want.keys() == start.keys()
    for k in want:
        tol = max(1e-5 * float(np.abs(want[k]).max()), 1e-2 * AC_LR)
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol,
                                   err_msg=k)
        upd_j, upd_t = want[k] - start[k], got[k] - start[k]
        if np.any(upd_j):
            err = np.linalg.norm(upd_t - upd_j) / np.linalg.norm(upd_j)
            assert err < 1e-4, f"{k}: update relative norm error {err}"
    m = CheckpointManager(str(tmp_path))
    assert m._complete_steps()[-1] == AC_STEPS - 1
    # the final checkpoint carries the loader's cursor after every batch
    ds = m.restore_data_state(AC_STEPS - 1)
    loader = _loader("port", mlm_files)
    it = iter(loader)
    for _ in range(AC_STEPS):
        next(it)
    assert ds == loader.state()
    m.close()


def test_auto_checkpoint_crash_and_resume_equals_uninterrupted(
        jax_bert_run, mlm_files, tmp_path):
    """A crash in step 4 (after step 3) and a resume from the step-2
    checkpoint, the loader's cursor restored: the port's losses of steps
    3-5 and its final state equal the uninterrupted run's bitwise."""
    p0, s0, _, _ = jax_bert_run
    clean = {}
    want = _port_auto(str(tmp_path / "clean"), p0, s0, mlm_files, clean)
    first = {}
    with pytest.raises(RuntimeError, match="killed"):
        _port_auto(str(tmp_path / "crash"), p0, s0, mlm_files, first,
                   crash_at=4)
    assert sorted(first) == [0, 1, 2, 3]
    second = {}
    got = _port_auto(str(tmp_path / "crash"), p0, s0, mlm_files, second)
    assert sorted(second) == [3, 4, 5]
    for i in range(AC_STEPS):
        assert (first.get(i, second.get(i)) == clean[i]), i
    _assert_same(got, want)


def test_sigterm_saves_the_step_and_exits_143(mlm_files, tmp_path):
    """The trainer process of chip_smoke's phase 57 on bert_tiny on the
    CPU: SIGTERM after step 4 (no multiple of the interval 3) saves step
    4, drains the writer and exits 143; the file holds the process's
    state after step 4 bitwise, and a new process resumes at step 5."""
    import chip_smoke
    from paddle_tpu_torch import native
    ck = str(tmp_path / "ck")
    base = dict(model="tiny", vocab=512, device="cpu", files=mlm_files,
                batch=AC_B, shuffle=8, seed=3, lr=AC_LR, steps=7, every=3,
                keep=2, checkpoint=True, ckpt=ck)
    rc, rec, _, err = chip_smoke.spawn_ckpt_run(
        dict(base, label="c", out=str(tmp_path / "c.json"),
             sigterm_after=4, digest_after=[4]),
        native._BUILD_DIR, timeout=240, sigterm=True)
    assert rc == 143, err
    m = CheckpointManager(ck)
    assert m.latest_step() == 4
    tree, _ = m.restore(device="cpu")
    assert chip_smoke.state_digest(tree) == rec["digests"]["4"]
    m.close()
    rc, rec2, _, err = chip_smoke.spawn_ckpt_run(
        dict(base, label="d", out=str(tmp_path / "d.json")),
        native._BUILD_DIR, timeout=240)
    assert rc == 0, err
    assert rec2["start_step"] == 5 and rec2["restored_digest"] == \
        rec["digests"]["4"]
    assert len(rec2["losses"]) == 2


# ---------------------------------------------------------------------------
# the build cache (core/compile_cache.py): stub libraries named by the real
# fingerprints, nothing built
# ---------------------------------------------------------------------------
@pytest.fixture
def cache():
    from paddle_tpu_torch.core import compile_cache
    compile_cache.disable()
    compile_cache.reset_stats()
    yield compile_cache
    compile_cache.disable()
    compile_cache.reset_stats()


def _count(name):
    return REGISTRY.get(name).value()


def test_cache_redirects_both_build_directories(cache, tmp_path):
    from paddle_tpu_torch import native
    from paddle_tpu_torch.ops.kernels import _build
    default_lib = _build._lib_path("layer_norm")
    assert os.path.dirname(default_lib) == _build._BUILD_DIR
    d = cache.enable(str(tmp_path / "cc"))
    assert cache.is_enabled() and cache.cache_dir() == d
    lib = _build._lib_path("layer_norm")
    assert os.path.dirname(lib) == d
    assert os.path.basename(lib) == os.path.basename(default_lib)
    # the native library: a file under its fingerprint is found, not built
    stub = os.path.join(d, f"libpt_native_{native._src_fingerprint()}.so")
    open(stub, "wb").close()
    assert native._build() == stub
    cache.disable()
    assert not cache.is_enabled()
    assert _build._lib_path("layer_norm") == default_lib


def test_cache_counts_a_found_library_as_a_hit_and_a_build_as_a_miss(
        cache, tmp_path, monkeypatch):
    from paddle_tpu_torch import native
    from paddle_tpu_torch.ops.kernels import _build
    d = cache.enable(str(tmp_path / "cc"))
    h0, m0, r0 = (_count(f"compile_cache_{k}_total")
                  for k in ("hits", "misses", "requests"))
    # a native build (g++ replaced by a stub writer): a miss; the second
    # lookup under the same fingerprint finds it: a hit
    built = []

    def fake_compile(srcs, out):
        built.append(out)
        open(out, "wb").close()
        return out
    monkeypatch.setattr(native, "_compile", fake_compile)
    so = native._build()
    assert built == [so] and os.path.dirname(so) == d
    assert cache.stats() == {"hits": 0, "misses": 1, "requests": 1}
    assert native._build() == so and len(built) == 1
    assert cache.stats() == {"hits": 1, "misses": 1, "requests": 2}
    # kernel libraries present under their fingerprints: hits, no nvcc
    for name in ("layer_norm", "fused_adam"):
        open(_build._lib_path(name), "wb").close()
    monkeypatch.setattr(_build, "_nvcc", lambda: pytest.fail("nvcc ran"))
    out = _build.build(["layer_norm", "fused_adam"])
    assert all(r["seconds"] == 0.0 for r in out.values())
    assert cache.stats() == {"hits": 3, "misses": 1, "requests": 4}
    # the registry carries the JAX package's counter names
    assert (_count("compile_cache_hits_total") - h0,
            _count("compile_cache_misses_total") - m0,
            _count("compile_cache_requests_total") - r0) == (3, 1, 4)
    import paddle_tpu_torch as tpt
    assert tpt.profiler.compilation_cache_stats() == cache.stats()
    assert f"compilation cache: 3 hits / 1 misses ({d})" in \
        tpt.profiler.summary()
    cache.reset_stats()
    assert cache.stats() == {"hits": 0, "misses": 0, "requests": 0}


def test_cache_names_match_the_jax_module(cache):
    from paddle_tpu.core import compile_cache as jcc
    for name in jcc.__all__:
        assert hasattr(cache, name), name
    assert cache.ENV_VAR == jcc.ENV_VAR == "PADDLE_TPU_CACHE_DIR"
    assert set(cache.stats()) == set(jcc.stats())


def test_cache_env_variable_is_honoured_at_import(tmp_path):
    d = str(tmp_path / "envcache")
    code = ("import paddle_tpu_torch\n"
            "from paddle_tpu_torch.core import compile_cache\n"
            "from paddle_tpu_torch.ops.kernels import _build\n"
            "print(compile_cache.cache_dir())\n"
            "print(_build._lib_path('fused_adam'))\n")
    env = dict(os.environ, PADDLE_TPU_CACHE_DIR=d, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stderr
    got_dir, lib = r.stdout.split()
    assert got_dir == d and os.path.dirname(lib) == d and os.path.isdir(d)


def test_cache_enabled_after_a_library_loaded_warns_once(cache, tmp_path,
                                                         monkeypatch):
    from paddle_tpu_torch.core import enforce
    from paddle_tpu_torch.ops.kernels import _build
    enforce._warned_keys.discard("compile_cache_mid_process")
    monkeypatch.setattr(_build, "_libs", {"layer_norm": object()})
    with pytest.warns(UserWarning, match="mid-process"):
        cache.enable(str(tmp_path / "a"))
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        cache.enable(str(tmp_path / "b"))


# ---------------------------------------------------------------------------
# save_vars / load_vars / append_save_op: the files cross the packages
# ---------------------------------------------------------------------------
def _ctr(pkg):
    if pkg == "jax":
        import paddle_tpu as p
    else:
        import paddle_tpu_torch as p
    from paddle_tpu_torch.models import ctr_dnn
    cfg = ctr_dnn.ctr_dnn_tiny()
    net = ctr_dnn.ctr_dnn(p, cfg)
    return p, cfg, net


def _feed(cfg, seed):
    rng = np.random.RandomState(seed)
    feed = {"dense_input": rng.rand(cfg.batch, cfg.dense_dim)
            .astype(np.float32),
            "label": rng.randint(0, 2, (cfg.batch, 1)).astype(np.int64)}
    for i in range(cfg.sparse_slots):
        feed[f"C{i + 1}"] = rng.randint(
            0, cfg.sparse_feature_dim, (cfg.batch, 1)).astype(np.int64)
    return feed


def _np_of(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def test_save_vars_files_load_in_the_other_package(tmp_path):
    jpt, cfg, jnet = _ctr("jax")
    tpt, _, tnet = _ctr("port")
    # JAX: startup, save_vars (the persistables) -> the port's load_vars
    jscope = jpt.static.Scope()
    jexe = jpt.static.Executor()
    jexe.run(jnet["startup"], scope=jscope)
    with jpt.static.scope_guard(jscope):
        jpt.io.save_vars(jexe, str(tmp_path / "j"),
                         main_program=jnet["main"])
    texe = tpt.Executor(tpt.CPUPlace())
    tscope = tpt.Scope()
    with tpt.scope_guard(tscope):
        tpt.io.load_vars(texe, str(tmp_path / "j"),
                         main_program=tnet["main"])
    names = sorted(n for n, v in jnet["main"].global_block().vars.items()
                   if v.persistable and jscope.find_var(n) is not None)
    assert names
    for n in names:
        t = tscope.find_var(n)
        assert t.device == torch.device("cpu")
        assert _np_of(t).tobytes() == _np_of(jscope.find_var(n)).tobytes(), n
    # the port: startup + one step, save_vars -> the JAX package's
    # load_vars; an explicit var list too
    tscope = tpt.Scope()
    texe.run(tnet["startup"], scope=tscope)
    texe.run(tnet["main"], feed=_feed(cfg, 1), fetch_list=[tnet["loss"]],
             scope=tscope)
    params = [p.name for p in tnet["main"].global_block().all_parameters()]
    with tpt.scope_guard(tscope):
        tpt.io.save_vars(texe, str(tmp_path / "t"),
                         main_program=tnet["main"])
        tpt.io.save_vars(texe, str(tmp_path / "t"), vars=params,
                         filename="params_only.npz")
    for fname, want in ((None, names), ("params_only.npz", params)):
        jscope = jpt.static.Scope()
        with jpt.static.scope_guard(jscope):
            jpt.io.load_vars(jexe, str(tmp_path / "t"), filename=fname)
        for n in want:
            assert _np_of(jscope.find_var(n)).tobytes() == \
                _np_of(tscope.find_var(n)).tobytes(), n
    # load_vars refuses a var the file lacks, by name
    with tpt.scope_guard(tpt.Scope()):
        with pytest.raises(Exception, match="not in file"):
            tpt.io.load_vars(texe, str(tmp_path / "t"),
                             filename="params_only.npz", vars=["nope"])


def test_save_combine_op_files_load_in_the_other_package(tmp_path):
    """``append_save_op`` after ``minimize``: each run writes the updated
    parameters; the port's file loads in the JAX package and the JAX
    package's in the port, bitwise."""
    jpt, cfg, jnet = _ctr("jax")
    tpt, _, tnet = _ctr("port")
    feed = _feed(cfg, 2)
    texe, tscope = tpt.Executor(tpt.CPUPlace()), tpt.Scope()
    texe.run(tnet["startup"], scope=tscope)
    params = [p.name for p in tnet["main"].global_block().all_parameters()]
    op = tpt.static.io.append_save_op(tnet["main"], params,
                                      str(tmp_path / "t" / "after"))
    assert op.type == "save_combine" and op.attrs["_host"]
    texe.run(tnet["main"], feed=feed, fetch_list=[tnet["loss"]],
             scope=tscope)
    jscope = jpt.static.Scope()
    with jpt.static.scope_guard(jscope):
        jpt.io.load_vars(jpt.static.Executor(), str(tmp_path / "t"),
                         filename="after.npz")
    for n in params:
        assert _np_of(jscope.find_var(n)).tobytes() == \
            _np_of(tscope.find_var(n)).tobytes(), n
    # the JAX package's save_combine file -> the port's load_vars and
    # its load_combine op
    jexe, jscope = jpt.static.Executor(), jpt.static.Scope()
    jexe.run(jnet["startup"], scope=jscope)
    jpt.static.io.append_save_op(jnet["main"], params,
                                 str(tmp_path / "j" / "after"))
    jexe.run(jnet["main"], feed=feed, fetch_list=[jnet["loss"]],
             scope=jscope)
    tscope = tpt.Scope()
    with tpt.scope_guard(tscope):
        tpt.io.load_vars(texe, str(tmp_path / "j"), vars=params,
                         filename="after.npz")
    for n in params:
        assert _np_of(tscope.find_var(n)).tobytes() == \
            _np_of(jscope.find_var(n)).tobytes(), n
