"""The device-memory monitor of the port (``paddle_tpu_torch/monitor/
memory.py``) against the JAX package's, on the CPU (the card's own reads,
``torch.cuda.mem_get_info`` and a real ``OutOfMemoryError``, are in
``tests/test_torch_cuda.py``).

Equal across the packages: the entity ledger after the same seeded sequence
of sets and removals (entries, totals under a prefix, the sorted table),
``admission_headroom`` over seeded projections and limits, ``is_oom_error``
over the same exceptions, and ``hbm_limit_bytes``' fallback to
``PADDLE_TPU_HBM_LIMIT_BYTES`` (a CPU device reports no capacity in either
package). Then the port's own: the HBM-pressure shed input, the typed OOM
postmortem, the poller's lifecycle and what stays with ROADMAP queue 1 item
10.
"""

import numpy as np
import pytest
import torch

from paddle_tpu.monitor import memory as jmem

from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.monitor import memory as tmem
from paddle_tpu_torch.serving.resilience import ShedController

ENV = "PADDLE_TPU_HBM_LIMIT_BYTES"


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.delenv(ENV, raising=False)
    jmem.reset()
    tmem.reset()
    yield
    jmem.reset()
    tmem.reset()


def _ledger_run(mem, seed):
    rng = np.random.RandomState(seed)
    names = [f"serving/pool{i}:{r}/{k}" for i in range(3)
             for r in ("live", "standby") for k in ("params", "bucket8")]
    out = []
    for _ in range(60):
        n = names[rng.randint(len(names))]
        if rng.rand() < 0.3:
            mem.ledger_remove(n)
        else:
            mem.ledger_set(n, float(rng.randint(1, 1 << 30)))
        out.append((mem.ledger(), mem.ledger("serving/pool1"),
                    mem.ledger_total(), mem.ledger_total("serving/pool0"),
                    mem.ledger_table(top=3)))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_ledger_like_jax(seed):
    assert _ledger_run(tmem, seed) == _ledger_run(jmem, seed)


def test_admission_headroom_like_jax(monkeypatch):
    rng = np.random.RandomState(3)
    for mem in (jmem, tmem):
        mem.ledger_set("serving/pool0:live/params", 5e8)
    for _ in range(40):
        projected = int(rng.randint(0, 1 << 31))
        limit = None if rng.rand() < 0.3 else int(rng.randint(1, 1 << 31))
        got = tmem.admission_headroom(projected, limit=limit)
        assert got == jmem.admission_headroom(projected, limit=limit)
    assert tmem.admission_headroom(10) == (True, 500000010, None)
    monkeypatch.setenv(ENV, "6e8")
    for projected in (10, 1e8, 1e8 + 1):
        assert tmem.admission_headroom(projected) == \
            jmem.admission_headroom(projected)
    assert tmem.admission_headroom(1e8) == (True, 600000000, 600000000)
    assert tmem.admission_headroom(1e8 + 1)[0] is False


def test_hbm_limit_env_fallback_like_jax(monkeypatch):
    import jax
    jdev = jax.devices("cpu")[0]
    for v in (None, "123456789", "1e9", "junk", ""):
        if v is None:
            monkeypatch.delenv(ENV, raising=False)
        else:
            monkeypatch.setenv(ENV, v)
        want = jmem.hbm_limit_bytes()
        assert tmem.hbm_limit_bytes() == want, v
        assert tmem.hbm_limit_bytes(torch.device("cpu")) == \
            jmem.hbm_limit_bytes(jdev) == want, v
    monkeypatch.setenv(ENV, "1e9")
    assert tmem.hbm_limit_bytes("cpu") == 1_000_000_000


def test_is_oom_error_like_jax():
    cases = [None, MemoryError(), ValueError("bad shape"),
             RuntimeError("RESOURCE_EXHAUSTED: Out of memory allocating"),
             RuntimeError("resource exhausted"), RuntimeError("OOM"),
             RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB"),
             KeyError("x"), RuntimeError("")]
    assert [tmem.is_oom_error(e) for e in cases] == \
        [jmem.is_oom_error(e) for e in cases] == \
        [False, True, False, True, True, True, True, False, False]
    assert tmem.is_oom_error(torch.cuda.OutOfMemoryError("CUDA error"))
    assert tmem.is_oom_error(tmem.OutOfDeviceMemoryError("typed"))
    assert jmem.is_oom_error(jmem.OutOfDeviceMemoryError("typed"))


def test_handle_oom_raises_typed_with_postmortem():
    from paddle_tpu_torch.monitor.registry import REGISTRY
    tmem.ledger_set("serving/pool0:live/params", 4096)
    c = REGISTRY.get("oom_errors_total")
    before = c.value(where="test/where")
    trips = REGISTRY.get("anomaly_trips_total")
    trips0 = trips.value(kind="oom") if trips is not None else 0.0
    err = torch.cuda.OutOfMemoryError("CUDA out of memory")
    with pytest.raises(tmem.OutOfDeviceMemoryError,
                       match="out of memory at test/where") as ei:
        tmem.handle_oom(err, "test/where")
    assert ei.value.__cause__ is err
    pm = ei.value.postmortem
    assert set(pm) == {"where", "error", "ledger", "top_live_buffers",
                       "peak_bytes", "hbm_bytes_in_use", "hbm_bytes_limit",
                       "hbm_bytes_high_water", "segments",
                       "peak_bytes_estimate"}
    # the escalation through anomaly.trip("oom"), as in the JAX package
    assert REGISTRY.get("anomaly_trips_total").value(kind="oom") == \
        trips0 + 1
    assert pm["ledger"] == [("serving/pool0:live/params", 4096.0)]
    assert pm["top_live_buffers"] == [] and pm["hbm_bytes_limit"] is None
    assert c.value(where="test/where") == before + 1


def test_shed_sheds_on_hbm_pressure_like_jax():
    """``shed_hbm_frac``: the worst card's utilization at or above it sheds
    with ``reason="hbm_pressure"``, in both packages (the utilization
    series set as the poller sets it)."""
    from paddle_tpu.serving.resilience import ShedController as JShed
    verdicts = []
    for mem, Shed in ((jmem, JShed), (tmem, ShedController)):
        shed = Shed(deadline_ms=100.0, hbm_high_frac=0.8)
        row = [shed.should_shed(100.0, 0)]
        mem._g_util.set(0.85, device="gpu:0")
        row.append(shed.should_shed(100.0, 0))
        mem._g_util.set(0.5, device="gpu:0")
        row.append(shed.should_shed(100.0, 0))
        row.append(mem.hbm_utilization_max())
        shed.shutdown()
        verdicts.append(row)
    assert verdicts[0] == verdicts[1] == [None, "hbm_pressure", None, 0.5]
    with pytest.raises(EnforceNotMet):
        ShedController(deadline_ms=100.0, hbm_high_frac=1.5)


class _FakeCompiled:
    """A stand-in for the JAX package's compiled executable: the memory
    analysis XLA reports."""

    def memory_analysis(self):
        class MA:
            argument_size_in_bytes = 100
            output_size_in_bytes = 10
            temp_size_in_bytes = 300
            alias_size_in_bytes = 0
            generated_code_size_in_bytes = 0
        return MA()


def test_poller_and_what_stays_with_item_10():
    assert tmem.sample_now() == {} and tmem.device_usage() == {}
    assert tmem.top_live_buffers() == [] and tmem.high_water() == 0
    tmem.enable(interval=0.01)
    assert tmem.poller_enabled()
    tmem.enable(interval=0.01)          # idempotent
    tmem.disable()
    assert not tmem.poller_enabled()
    assert tmem.summary_line() is None
    tmem.ledger_set("a", 2048)
    assert tmem.summary_line() == "memory: top: a=2.00KB"
    # the per-step peak: nothing measured on the CPU, and a measured step
    # gives the JAX analysis dict, read back as the JAX package reads its
    # compile-time one
    assert tmem.analyze_compiled(None) is None
    assert tmem.memory_segments() == {} and tmem.peak_bytes_per_step() == 0
    a = tmem.analyze_compiled({"argument_bytes": 100, "start_bytes": 1000,
                               "peak_bytes": 1300})
    assert a == {"argument_bytes": 100.0, "output_bytes": 0.0,
                 "temp_bytes": 300.0, "alias_bytes": 0.0,
                 "generated_code_bytes": 0.0, "peak_bytes_estimate": 400.0}
    assert set(a) == set(jmem.analyze_compiled(_FakeCompiled()))
    tmem.record_segment_memory(7, 0, a)
    tmem.record_segment_memory(7, 1, dict(a, peak_bytes_estimate=50.0))
    assert tmem.peak_bytes_per_step() == 400.0
    assert sorted(tmem.memory_segments()) == [0, 1]
    tmem.record_segment_memory(8, 0, dict(a, peak_bytes_estimate=90.0))
    assert tmem.peak_bytes_per_step() == 90.0    # the latest runner wins
    assert tmem.oom_postmortem("x")["peak_bytes_estimate"] == 90.0
