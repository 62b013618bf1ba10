"""`utils/profiling.py` on the CPU: `SimMeter` against the JAX package's on
the same records, `trace_context` (nothing for a falsy directory, a Chrome
trace otherwise) and `device_memory_stats` ({} where there is no card)."""
import json
import os

import pytest
import torch

from fast_monte_carlo_tpu.utils import profiling as jprof
from fast_monte_carlo_tpu_torch.utils import profiling

torch.set_num_threads(1)

RECORDS = [("build", {"what": "tables"}, 1.25), ("simulate", {"games": 65536}, 0.5),
           ("save", {}, 0.125), ("io", {"file": "x"}, 0.0625), ("price", {}, 0.03125)]


def _fill(meter):
    for name, meta, seconds in RECORDS:
        with meter.phase(name, **meta):
            pass
        meter.records[-1]["seconds"] = seconds     # the same clock for both meters
    meter.record_run(131072, 2.0, mode="table")
    meter.record_run(0, 0.0)
    return meter


@pytest.mark.parametrize("records", [True, False])
def test_sim_meter_equals_jax(records):
    got = _fill(profiling.SimMeter()) if records else profiling.SimMeter()
    want = _fill(jprof.SimMeter()) if records else jprof.SimMeter()
    assert got.records == want.records
    assert got.summary() == want.summary()
    assert got.dump() == want.dump()
    if records:
        assert got.summary()["games"] == 65536 + 131072
        assert [json.loads(x)["phase"] for x in got.dump().splitlines()][-1] == "simulate"


def test_sim_meter_phase_records_a_failing_block():
    m = profiling.SimMeter()
    with pytest.raises(RuntimeError):
        with m.phase("boom", step=1):
            raise RuntimeError("x")
    assert m.records[0]["phase"] == "boom" and m.records[0]["step"] == 1
    assert m.records[0]["seconds"] >= 0


@pytest.mark.parametrize("log_dir", [None, ""])
def test_trace_context_falsy_does_nothing(log_dir, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    ran = []
    with profiling.trace_context(log_dir):
        ran.append(torch.ones(3).sum().item())
    assert ran == [3.0] and os.listdir(tmp_path) == []


def test_trace_context_writes_a_chrome_trace(tmp_path):
    d = tmp_path / "trace"
    with profiling.trace_context(str(d)):
        torch.arange(1000.0).cumsum(0).sum()
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".json")
    trace = json.loads((d / files[0]).read_text())
    assert trace["traceEvents"] and any("cumsum" in str(e.get("name", ""))
                                        for e in trace["traceEvents"])


def test_device_memory_stats_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    assert profiling.device_memory_stats() == {}
