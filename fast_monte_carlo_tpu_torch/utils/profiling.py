"""Observability: a phase and games/s meter, torch.profiler traces and the
card's memory, a port of fast_monte_carlo_tpu/utils/profiling.py.

`SimMeter` is the JAX package's, copied.  `trace_context` writes a Chrome
trace of what runs inside it (host and, where there is a card, device
activity) into a directory; `device_memory_stats` reads the caching
allocator's counters of each card.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class SimMeter:
    """Phase timer + games/sec meter with structured output."""

    records: List[Dict] = field(default_factory=list)
    _starts: Dict[str, float] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str, **meta):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.records.append({"phase": name, "seconds": dt, **meta})

    def record_run(self, n_games: int, seconds: float, **meta) -> float:
        rate = n_games / seconds if seconds > 0 else float("inf")
        self.records.append({"phase": "simulate", "seconds": seconds,
                             "games": n_games, "games_per_sec": rate, **meta})
        return rate

    def summary(self) -> Dict:
        total = sum(r["seconds"] for r in self.records)
        sim = [r for r in self.records if r["phase"] == "simulate"]
        out = {"total_time_sec": total,
               "sim_time_sec": sum(r["seconds"] for r in sim),
               "io_time_sec": sum(r["seconds"] for r in self.records
                                  if r["phase"] in ("save", "io"))}
        if sim:
            out["games"] = sum(r.get("games", 0) for r in sim)
            out["games_per_sec"] = out["games"] / out["sim_time_sec"] \
                if out["sim_time_sec"] else 0.0
        return out

    def dump(self) -> str:
        return "\n".join(json.dumps(r) for r in self.records)


@contextlib.contextmanager
def trace_context(log_dir: Optional[str]):
    """torch.profiler over the block, its Chrome trace written to
    log_dir/trace_<pid>_<ns>.json (the directory made if absent); CUDA
    activity is traced where a card is present.  Nothing happens when
    `log_dir` is falsy."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.perf_counter_ns()}.json"))


def device_memory_stats() -> Dict:
    """Per card ("cuda:i"): bytes_in_use and peak_bytes_in_use (the caching
    allocator's allocated bytes, now and at their peak since the last
    reset) and bytes_limit (the card's memory); {} where there is no card."""
    import torch

    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": {"bytes_in_use": torch.cuda.memory_allocated(i),
                          "peak_bytes_in_use": torch.cuda.max_memory_allocated(i),
                          "bytes_limit": torch.cuda.get_device_properties(i).total_memory}
            for i in range(torch.cuda.device_count())}
