"""Long-lived HTTP serving layer over the slate/matchup/prop entry points:
port of fast_monte_carlo_tpu/serve.py.

A question answered by a fresh process pays for loading the trained heads,
building both teams' nano tables and packing the matchup before its first
game (`PERF.md` §5: seconds of host set-up against a warm query's launch).
The production shape is therefore ONE resident process whose heads stay
loaded (`models.heads.load_heads` memo), whose nano tables and runners stay
on the card (`ops.table_lookup` and `api` runner memos) and whose kernels
stay built.  This module is that resident process with a JSON/HTTP front:

    POST /slate   {"games": [["Team A","Team B"], ...],
                   "n_pairs": 32768, "shard": false,
                   "lines": [{"team_a": "Team A", "spread": -3.5,
                              "total": 55.5}]}
    POST /sim     {"team_a": "...", "team_b": "...", "n_pairs": 32768,
                   "spread": -3.5, "total": 55.5}
    POST /props   {"games": [...], "props": [{prop-sheet rows}], ...}
    POST /live    {"team_a": "...", "team_b": "...", "offense": "A",
                   "quarter": 4, "clock": "05:12", "down": 2, "dist": 7,
                   "ytg": 35, "score_a": 21, "score_b": 17,
                   "spread": -3.5, "total": 55.5}
                  (or "situations": [{...}, ...] — a win-prob curve,
                   every situation priced in ONE launch)
    POST /fourth  {"team_a": "...", "team_b": "...", "offense": "A",
                   "quarter": 4, "clock": "05:00", "dist": 2, "ytg": 30,
                   "score_a": 20, "score_b": 21}
    POST /season  {"team": "...", "opponents": ["...", ...],
                   "line": 8.5, "n_pairs": 32768}
    GET  /health  liveness + device/cache state

Routes, status codes (400 bad request, 404 unknown path, 500 a failure in
the simulation, 503 shed by the admission deadline) and response keys are
the JAX module's; /health also names the card (`device_name`).  Everything
is stdlib and torch: no pandas.  The entry points' pandas-free cores give
rows, which `_frame_records` lays out as the JAX module's DataFrames come
out of `to_dict(orient="records")`.

`ThreadingHTTPServer` answers each request on its own thread while one
service lock serializes device work and every memo write (the kernels
launch on the calling thread's current stream, the default stream in
every handler thread).  `ServeConfig.device` names the card ("cuda") or,
for the tests, "cpu"; a service asked for CUDA where there is none raises
when it is built.  A kernel that fails to build or launch reaches the
client as a 500 with its message: nothing falls back to a plain version or
to the CPU.

A request's `"shard": true` splits its launches over the ranks of
`parallel.mesh.trial_group` (in a process of one rank, a world of one).  A
server started as several ranks (`torchrun`, `cli serve --shard`) answers
HTTP on rank 0 only; every other rank runs `SimService.follow`: rank 0
sends it each entry-point call that reaches device work, under the service
lock that orders the calls (`_call`, `broadcast_object_list` on a gloo
group of its own, whose long timeout lets a server idle), and every rank
runs the call, so the collectives inside it meet.  After each call the
ranks agree on its outcome (`parallel.mesh.agree` on that group): where
any rank failed, rank 0 answers an error, never a result.  The sharded
launches inside a call agree the same way before their data's
collectives, so a launch that fails on one card (out of memory, a kernel
that does not build) fails on every rank instead of hanging the others.
A rank that fails in host code between those points still leaves the
others waiting until the process group's timeout.

Coalesced /sim requests differ from the JAX module on purpose.  There the
leader plays a batch of distinct matchups as one slate, so matchup gi's key
is folded from its position in the batch and an answer depends on which
other requests were in flight (`fast_monte_carlo_tpu/serve.py:438-456`).
Here each matchup of a batch runs as a slate of one, under the key a solo
request gets (fold_in(root_key(seed), 0)), so a coalesced answer equals
the solo one bit for bit.  The JAX module's slate launches once per matchup
too, so no launch is added.
"""
from __future__ import annotations

import collections
import datetime
import json
import math
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np
import torch

from . import resolve_device
from .models.heads import DEFAULT_ARTIFACT_DIR


def jsonable(o):
    """Recursively convert API outputs (row dicts and lists, numpy scalars,
    NaN) into JSON-encodable structures: NaN and inf become None, numpy
    scalars Python numbers."""
    if isinstance(o, dict):
        return {str(k): jsonable(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [jsonable(v) for v in o]
    if isinstance(o, np.generic):
        o = o.item()
    if isinstance(o, float) and not math.isfinite(o):
        return None
    return o


def _frame_records(rows: List[dict]) -> List[dict]:
    """Row dicts as `pd.DataFrame(rows).to_dict(orient="records")` gives
    them: every row has every column, in first-seen order, NaN where the
    row had none."""
    cols = list(dict.fromkeys(k for r in rows for k in r))
    return [{c: r.get(c, math.nan) for c in cols} for r in rows]


def _columns_records(cols: dict) -> List[dict]:
    """A dict of equal-length columns as row dicts."""
    n = len(next(iter(cols.values()), ()))
    return [{c: v[i] for c, v in cols.items()} for i in range(n)]


def corr_records(labels, corr) -> List[dict]:
    """A (labels, (L, L) correlations) pair as the records of the JAX
    package's leg-correlation DataFrame: one dict a leg, keyed by label."""
    return [dict(zip(labels, r)) for r in np.asarray(corr)]


class Overloaded(RuntimeError):
    """Request shed by the admission deadline (mapped to HTTP 503)."""


class _BatchItem:
    """One matchup's slot in a coalesced /sim batch."""
    __slots__ = ("evt", "out", "err", "waiters")

    def __init__(self):
        self.evt = threading.Event()
        self.out = None      # (summary_row_dict, ScoreSummary)
        self.err = None
        self.waiters = 0     # requests registered on this slot (observability)


class _SimBatch:
    """Open /sim batch for one (n_pairs, mode, shard, seed) group: requests
    arriving while the device lock is busy register their matchup here; the
    group's first arrival (the leader) seals the batch when it ACQUIRES the
    lock and answers every matchup, each as a slate of one."""
    __slots__ = ("items",)

    def __init__(self):
        self.items: dict = {}   # (team_a, team_b) -> _BatchItem


@dataclass(frozen=True)
class ServeConfig:
    """Static per-process serving configuration (the request body carries
    only per-question knobs: games, trial counts, lines, prop rows)."""
    sp_path: str
    artifact_dir: str = DEFAULT_ARTIFACT_DIR   # the JAX module's default
    year: int = 2025
    week: int = 1
    mode: str = "table"
    table_quality: str = "nano"
    focus_csv: Optional[str] = None
    shard: bool = False          # default; request "shard" overrides
    max_n_pairs: int = 2_000_000  # per-request guard
    max_games: int = 80          # per-request slate bound (weekly ~60)
    # per-request admission deadline: a request that spends longer than
    # this QUEUED behind the device lock is shed with 503 before any
    # device work launches (a launched run can't be aborted, so the guard
    # bounds queue wait, not the running sim).  None or <=0 = never shed.
    deadline_s: Optional[float] = None
    # The JAX module's AOT executable snapshot directory.  Kept so that the
    # two configurations have the same fields; ignored here: eager PyTorch
    # has no compiled program to snapshot, and the kernels are built once
    # per process from csrc/.  /health reports it as given.
    aot_dir: Optional[str] = None
    # the service's device: "cuda" (the card) or "cpu" (the tests)
    device: str = "cuda"


class SimService:
    """The resident simulation service: owns the warm state (heads memo,
    nano tables and runners on the device, built kernels all hydrate on
    first use and stay) and serializes device work behind one lock."""

    def __init__(self, cfg: ServeConfig):
        from .parallel.mesh import TrialGroup, trial_group, world_size

        self.cfg = cfg
        # raises here, before any request, for CUDA where there is none; a
        # server of several ranks plays on each rank's card
        self.group = trial_group(cfg.device) if world_size() > 1 else None
        self.device = self.group.device if self.group else resolve_device(cfg.device)
        self.rank = self.group.rank if self.group else 0
        # rank 0's channel to the followers: entry-point calls, in order
        self._cmd = None
        if self.group is not None:
            import torch.distributed as dist
            self._cmd = TrialGroup(self.rank, self.group.world, dist.new_group(
                backend="gloo", timeout=datetime.timedelta(days=365)), torch.device("cpu"))
        self._device_name = (torch.cuda.get_device_name(self.device)
                             if self.device.type == "cuda" else "cpu")
        self._lock = threading.Lock()
        self._t0 = time.time()
        self._requests = 0
        # per-endpoint completed-request latency rings (seconds, includes
        # queue wait); /health reports p50/p95 off them.  A dedicated
        # small lock guards ring append vs /health iteration — /health
        # must never 500 with 'deque mutated during iteration' under the
        # very load it exists to observe
        self._latency = collections.defaultdict(
            lambda: collections.deque(maxlen=512))
        self._lat_lock = threading.Lock()
        # /sim request coalescing: open batches by group
        self._batch_lock = threading.Lock()
        self._sim_batches: dict = {}
        self._coalesced = 0   # requests answered from another's launch
        # generic single-flight for the OTHER deterministic endpoints:
        # identical concurrent bodies share one computation
        self._inflight: dict = {}

    @contextmanager
    def _admit(self, endpoint: str, t0: float):
        """Device-lock admission with the deadline guard; records the
        endpoint's end-to-end latency on success."""
        dl = self.cfg.deadline_s
        if dl is not None and dl <= 0:
            dl = None   # 0/negative means 'no deadline', not 'shed all'
        if dl is None:
            acquired = self._lock.acquire()
        else:
            left = dl - (time.perf_counter() - t0)
            acquired = left > 0 and self._lock.acquire(timeout=left)
        if not acquired:
            raise Overloaded(
                f"queue wait exceeded deadline_s={dl}; retry later")
        try:
            self._requests += 1
            yield
        finally:
            self._lock.release()
        with self._lat_lock:
            self._latency[endpoint].append(time.perf_counter() - t0)

    def _single_flight(self, endpoint: str, body: dict, compute):
        """Share one computation across concurrent IDENTICAL requests.

        Every served endpoint is deterministic in its body (fixed seeds,
        committed artifacts), so two identical in-flight requests must
        return identical answers — the second can wait for the first's
        launch instead of queuing its own (the /live and /fourth polling
        patterns hit this constantly).  Leader computes under its own
        `_admit`; followers wait bounded by the admission deadline and
        get a shallow copy of the response (each request stamps its own
        elapsed_s).  Any leader failure propagates to all waiters.
        /sim has the richer cross-matchup batcher instead."""
        key = (endpoint, json.dumps(body, sort_keys=True, default=str))
        t0 = time.perf_counter()
        with self._batch_lock:
            item = self._inflight.get(key)
            leader = item is None
            if leader:
                item = self._inflight[key] = _BatchItem()
            item.waiters += 1
        if leader:
            try:
                item.out = compute()
            except BaseException as e:
                item.err = e
                raise
            finally:
                with self._batch_lock:
                    if self._inflight.get(key) is item:
                        del self._inflight[key]
                item.evt.set()
        else:
            self._await_batch_item(item, t0, endpoint=endpoint)
            if item.err is not None:
                raise item.err
        out = dict(item.out)
        out["elapsed_s"] = round(time.perf_counter() - t0, 3)
        return out

    def _call(self, name: str, *args, **kw):
        """`api.<name>(*args, **kw)` on this rank.  In a server of several
        ranks rank 0 first sends the call (without its device) to the
        followers, which run it on their own cards, and the ranks then
        agree on its outcome: where any rank failed, this raises.  Callers
        hold the service lock, so every rank sees the calls in one order."""
        from . import api
        from .parallel.mesh import agree

        if self._cmd is None:
            return getattr(api, name)(*args, **kw)
        import torch.distributed as dist
        dist.broadcast_object_list(
            [(name, args, {k: v for k, v in kw.items() if k != "device"})],
            src=0, group=self._cmd.group)
        return agree(self._cmd, lambda: getattr(api, name)(*args, **kw))

    def follow(self) -> None:
        """A follower rank's loop: run each call rank 0 sends, on this
        rank's device, and agree on its outcome with the other ranks (rank
        0 answers its client, with an error where any rank failed), until
        rank 0 sends None (`close`)."""
        import torch.distributed as dist
        from . import api
        from .parallel.mesh import agree

        while True:
            msg = [None]
            dist.broadcast_object_list(msg, src=0, group=self._cmd.group)
            if msg[0] is None:
                return
            name, args, kw = msg[0]
            try:
                agree(self._cmd, lambda: getattr(api, name)(*args, device=self.device, **kw))
            except Exception:  # noqa: BLE001 — rank 0 reports it
                pass

    def close(self) -> None:
        """Rank 0 of a server of several ranks releases the followers."""
        if self._cmd is not None and self.rank == 0:
            import torch.distributed as dist
            with self._lock:
                dist.broadcast_object_list([None], src=0, group=self._cmd.group)
            self._cmd = None

    def _route_kw(self, mode: str) -> dict:
        """The keywords every entry point takes from the configuration, and
        the request's `mode` (checked by `_mode`)."""
        return dict(sp_path=self.cfg.sp_path, year=self.cfg.year, week=self.cfg.week,
                    artifact_dir=self.cfg.artifact_dir, focus_csv=self.cfg.focus_csv,
                    mode=mode, table_quality=self.cfg.table_quality, device=self.device)

    # -- warmup ---------------------------------------------------------
    def warm(self, games=None, n_pairs: int = 256) -> dict:
        """Optional pre-hydration: load heads + SP table now (and, given
        `games`, run a tiny slate so table builds, uploads and kernel
        builds happen before the first real request)."""
        from .data.sp import load_sp_flex
        from .models.heads import load_heads

        with self._lock:
            load_heads(self.cfg.artifact_dir)
            load_sp_flex(self.cfg.sp_path)
        out = {"heads": "loaded", "sp": "loaded"}
        if games:
            self.slate({"games": games, "n_pairs": n_pairs})
            out["compiled"] = f"{len(games)} matchups @ {n_pairs} pairs"
        return out

    # -- endpoints ------------------------------------------------------
    def handle(self, name: str, body: dict) -> dict:
        """Route one POST: /sim goes to its cross-matchup batcher; every
        other endpoint gets identical-request single-flight (both are
        exact: all endpoints are deterministic in their body)."""
        if name == "sim":
            return self.sim(body)
        return self._single_flight(name, body,
                                   lambda: getattr(self, name)(body))

    def health(self) -> dict:
        """Liveness, the device, memo sizes and latency percentiles.  Reads
        without the service lock and never touches the device."""
        from .models.heads import _HEADS_MEMO
        from .ops.table_lookup import _TABLE_MEMO

        with self._lat_lock:
            rings = {ep: list(ring) for ep, ring in self._latency.items()}
        lat = {}
        for ep, ring in rings.items():
            if not ring:
                continue
            a = np.sort(np.asarray(ring))
            lat[ep] = {
                "n": len(a),
                "p50_ms": round(float(np.percentile(a, 50)) * 1e3, 1),
                "p95_ms": round(float(np.percentile(a, 95)) * 1e3, 1),
                "max_ms": round(float(a[-1]) * 1e3, 1),
            }
        return {
            "status": "ok",
            "platform": self.device.type,
            "device_count": (torch.cuda.device_count() if self.device.type == "cuda"
                             else 0),
            "device_name": self._device_name,
            "uptime_s": round(time.time() - self._t0, 1),
            "requests": self._requests,
            "coalesced": self._coalesced,
            "heads_memo": len(_HEADS_MEMO),
            "device_tables": len(_TABLE_MEMO),
            "latency": lat,
            "config": jsonable(self.cfg.__dict__),
        }

    def _n_pairs(self, body: dict, default: int) -> int:
        n = int(body.get("n_pairs", default))
        if not 0 < n <= self.cfg.max_n_pairs:
            raise ValueError(
                f"n_pairs must be in (0, {self.cfg.max_n_pairs}], got {n}")
        return n

    def _mode(self, body: dict) -> str:
        """Per-request mode override, bounded: only the configured mode or
        the cheap artifact-free 'analytic'.  A table-mode server asked for
        mode='exact' would walk every forest on every play and hold the
        service lock far longer than the n_pairs guard allows for."""
        mode = body.get("mode", self.cfg.mode)
        if mode not in (self.cfg.mode, "analytic"):
            raise ValueError(
                f"mode {mode!r} not served (this process runs "
                f"{self.cfg.mode!r}; 'analytic' also allowed)")
        return mode

    def _games(self, body: dict) -> list:
        games = [tuple(g) for g in body["games"]]
        if not 0 < len(games) <= self.cfg.max_games:
            raise ValueError(
                f"games list must have 1..{self.cfg.max_games} matchups, "
                f"got {len(games)} (each matchup builds device tables; "
                "raise ServeConfig.max_games deliberately if needed)")
        return games

    def slate(self, body: dict) -> dict:
        """Slate summaries (+ market pricing when `lines` rows are given):
        the per-matchup launch loop with one end transfer."""
        from .edge import slate_market_rows

        games = self._games(body)
        lines = body.get("lines")
        t0 = time.perf_counter()
        with self._admit("slate", t0):
            rows, summaries = self._call(
                "simulate_slate_summary_rows", games, n_pairs=self._n_pairs(body, 32768),
                shard=bool(body.get("shard", self.cfg.shard)),
                seed=int(body.get("seed", 0)), **self._route_kw(self._mode(body)))
            out = {"summaries": jsonable(_frame_records(rows))}
            if lines:
                out["markets"] = jsonable(_frame_records(
                    slate_market_rows(games, summaries, _frame_records(lines))))
        out["elapsed_s"] = round(time.perf_counter() - t0, 3)
        return out

    def sim(self, body: dict) -> dict:
        """One matchup: summary + fair moneyline, plus spread/total
        markets when quoted.

        Requests COALESCE: while the device lock is busy, /sim arrivals
        for the same (n_pairs, mode, shard, seed) group register their
        matchup in an open batch; the group's first arrival (the leader)
        seals the batch when it acquires the lock and answers every queued
        matchup.  Identical requests share one launch outright; each
        distinct matchup runs as a slate of one under the solo request's
        key, so every answer is exactly what a request alone would have
        returned.  Market/alt pricing stays per-request (host-side, off
        the shared summary)."""
        from .edge import (alt_line_rows_from_summary, market_odds_from_summary,
                           summary_moneyline)

        ta, tb = body["team_a"], body["team_b"]
        t0 = time.perf_counter()
        n_pairs = self._n_pairs(body, 32768)
        mode = self._mode(body)
        shard = bool(body.get("shard", self.cfg.shard))
        seed = int(body.get("seed", 0))
        # parse per-request knobs BEFORE joining a batch: a malformed
        # body must 400 without costing a device launch
        calib = _calibration_from_body(body)
        group = (n_pairs, mode, shard, seed)
        with self._batch_lock:
            batch = self._sim_batches.get(group)
            leader = batch is None
            if leader:
                batch = _SimBatch()
                self._sim_batches[group] = batch
            item = batch.items.get((ta, tb))
            if item is None:
                item = batch.items[(ta, tb)] = _BatchItem()
            item.waiters += 1
        if leader:
            self._run_sim_batch(group, batch, n_pairs, mode, shard, seed, t0)
        else:
            self._await_batch_item(item, t0)
        if item.err is not None:
            raise item.err
        row, summary = item.out
        out = {
            "summary": row,
            "moneyline": jsonable(summary_moneyline(summary, ta, tb,
                                                    calibration=calib)),
        }
        spread, total = body.get("spread"), body.get("total")
        if spread is not None or total is not None:
            out["markets"] = jsonable(market_odds_from_summary(
                summary, ta, tb,
                spread=None if spread is None else float(spread),
                total=None if total is None else float(total),
                calibration=calib))
            alt = body.get("alt")
            if alt:
                opts = alt if isinstance(alt, dict) else {}
                width = float(opts.get("width", 12.0))
                step = float(opts.get("step", 1.0))
                if not (step > 0 and width / step <= 100):
                    raise ValueError(
                        "alt ladder capped at 201 rows: need step > 0 "
                        "and width/step <= 100")
                out["alt"] = {
                    k: jsonable(_frame_records(v))
                    for k, v in alt_line_rows_from_summary(
                        summary, ta, tb,
                        spread=None if spread is None else float(spread),
                        total=None if total is None else float(total),
                        width=width, step=step,
                        calibration=calib).items()}
        out["elapsed_s"] = round(time.perf_counter() - t0, 3)
        return out

    def _run_sim_batch(self, group, batch: _SimBatch, n_pairs, mode, shard,
                       seed, t0) -> None:
        """Leader path: acquire the device lock, seal the batch, run every
        queued matchup as a slate of one (the solo request's launches and
        key), distribute results.  A matchup that fails fails alone; a
        failure outside them (an admission shed) fails the whole batch —
        followers re-raise the same exception."""
        def run(game):
            rows, summaries = self._call(
                "simulate_slate_summary_rows", [game], n_pairs=n_pairs, shard=shard, seed=seed,
                **self._route_kw(mode))
            return jsonable(rows[0]), summaries[0]

        try:
            with self._admit("sim", t0):
                with self._batch_lock:
                    # seal: arrivals from here on open the NEXT batch
                    if self._sim_batches.get(group) is batch:
                        del self._sim_batches[group]
                    games = list(batch.items.keys())
                for g in games:
                    try:
                        batch.items[g].out = run(g)
                    except Exception as ge:  # noqa: BLE001 — each request sees its own
                        batch.items[g].err = ge
            for it in batch.items.values():
                it.evt.set()
        except BaseException as e:
            with self._batch_lock:
                if self._sim_batches.get(group) is batch:
                    del self._sim_batches[group]
            for it in batch.items.values():
                if not it.evt.is_set():
                    it.err = e
                    it.evt.set()
            raise

    def _await_batch_item(self, item: _BatchItem, t0,
                          endpoint: str = "sim") -> None:
        """Follower path: wait for the leader's launch (bounded by the
        admission deadline) and record this request's own latency."""
        dl = self.cfg.deadline_s
        if dl is not None and dl <= 0:
            dl = None
        timeout = None if dl is None else max(0.0, dl - (time.perf_counter() - t0))
        if not item.evt.wait(timeout):
            raise Overloaded(
                f"queue wait exceeded deadline_s={dl}; retry later")
        if item.err is None:    # the ring records completed requests only
            with self._lat_lock:
                self._coalesced += 1
                self._latency[endpoint].append(time.perf_counter() - t0)

    def live(self, body: dict) -> dict:
        """In-game win probability + live market pricing: resume trials
        from the posted situation (possession/clock/down/distance/field
        position/score).

            POST /live {"team_a": "...", "team_b": "...",
                        "offense": "A", "sec": 1312, "down": 2,
                        "dist": 7, "ytg": 35, "score_a": 21, "score_b": 17,
                        "n_games": 65536, "spread": -3.5, "total": 55.5}

        `offense` accepts "A"/"B" or 0/1; `quarter` + `clock` ("MM:SS")
        may replace `sec`.

        Batch form (win-probability curve): pass `situations` — a list of
        situation objects with the same fields — instead of inline fields;
        all of them price in ONE launch (api.simulate_live_curve_columns)
        and the response carries one headline row per situation."""
        from .edge import market_odds_from_summary, summary_moneyline

        ta, tb = body["team_a"], body["team_b"]
        if "situations" in body:
            return self._live_curve(ta, tb, body)
        sit = _situation_from_body(body)
        n_games = int(body.get("n_games", 65536))
        if not 0 < n_games <= 2 * self.cfg.max_n_pairs:
            raise ValueError(
                f"n_games must be in (0, {2 * self.cfg.max_n_pairs}], "
                f"got {n_games}")
        t0 = time.perf_counter()
        with self._admit("live", t0):
            row, summary = self._call(
                "simulate_live_game", ta, tb, sit, n_games=n_games,
                shard=bool(body.get("shard", self.cfg.shard)),
                seed=int(body.get("seed", 0)), **self._route_kw(self._mode(body)))
            out = {
                "live": jsonable(row),
                "moneyline": jsonable(summary_moneyline(summary, ta, tb)),
            }
            spread, total = body.get("spread"), body.get("total")
            if spread is not None or total is not None:
                out["markets"] = jsonable(market_odds_from_summary(
                    summary, ta, tb,
                    spread=None if spread is None else float(spread),
                    total=None if total is None else float(total)))
        out["elapsed_s"] = round(time.perf_counter() - t0, 3)
        return out

    def _live_curve(self, ta: str, tb: str, body: dict) -> dict:
        """Batch form of /live: S situations in one launch."""
        raw = body["situations"]
        if not isinstance(raw, list) or not 0 < len(raw) <= 64:
            raise ValueError(
                "situations must be a JSON array of 1..64 objects")
        sits = [_situation_from_body(d) for d in raw]
        n_per = int(body.get("n_games_per", 8192))
        if not 0 < n_per * len(sits) <= 2 * self.cfg.max_n_pairs:
            raise ValueError(
                f"situations * n_games_per must be in "
                f"(0, {2 * self.cfg.max_n_pairs}], "
                f"got {len(sits)} * {n_per}")
        t0 = time.perf_counter()
        with self._admit("live_curve", t0):
            cols, _ = self._call(
                "simulate_live_curve_columns", ta, tb, sits, n_games_per=n_per, seed=int(body.get("seed", 0)),
                **self._route_kw(self._mode(body)))
        return {"curve": jsonable(_columns_records(cols)),
                "elapsed_s": round(time.perf_counter() - t0, 3)}

    def fourth(self, body: dict) -> dict:
        """4th-down decision chart from a posted situation.

            POST /fourth {"team_a": "...", "team_b": "...",
                          "offense": "A", "quarter": 4, "clock": "05:00",
                          "dist": 2, "ytg": 30, "score_a": 20,
                          "score_b": 21, "n_games": 65536}

        The situation's down is 4 by construction; the response carries
        win probability per forced choice (go/fg/punt) next to the sampled
        policy, plus the best choice and its CRN-paired delta
        (api.evaluate_fourth_down)."""
        if int(body.get("down", 4)) != 4:
            raise ValueError("/fourth prices 4th downs (down must be 4)")
        sit = _situation_from_body({**body, "down": 4})
        n_games = int(body.get("n_games", 65536))
        # 4 choices run per request — bound each like a /live query
        if not 0 < n_games <= 2 * self.cfg.max_n_pairs:
            raise ValueError(
                f"n_games must be in (0, {2 * self.cfg.max_n_pairs}], "
                f"got {n_games}")
        t0 = time.perf_counter()
        with self._admit("fourth", t0):
            res = self._call(
                "evaluate_fourth_down", body["team_a"], body["team_b"], sit, n_games=n_games,
                seed=int(body.get("seed", 0)), **self._route_kw(self._mode(body)))
        return {"fourth": jsonable(res),
                "elapsed_s": round(time.perf_counter() - t0, 3)}

    def season(self, body: dict) -> dict:
        """Season win-total projection: the schedule's per-game sims
        compose into the exact Poisson-binomial win-count distribution
        (api.project_season_rows).

            POST /season {"team": "...",
                          "opponents": ["...", ...],   # or "games": [[a,b],..]
                          "line": 8.5, "n_pairs": 32768}

        Returns the pmf, the P(>=k) alternate-line ladder, the over/under
        market at `line`, and the per-game schedule rows."""
        team = body["team"]
        opponents = body.get("opponents")
        games = body.get("games")
        if games is not None:
            games = self._games(body)
        if opponents is not None \
                and not 0 < len(opponents) <= self.cfg.max_games:
            raise ValueError(
                f"opponents list must have 1..{self.cfg.max_games} "
                f"entries, got {len(opponents)}")
        line = body.get("line")
        t0 = time.perf_counter()
        with self._admit("season", t0):
            res = self._call(
                "project_season_rows", team, opponents=opponents, games=games,
                line=None if line is None else float(line),
                n_pairs=self._n_pairs(body, 32768),
                shard=bool(body.get("shard", self.cfg.shard)),
                seed=int(body.get("seed", 0)), **self._route_kw(self._mode(body)))
        res["schedule"] = _frame_records(res["schedule"])
        return {"season": jsonable(res),
                "elapsed_s": round(time.perf_counter() - t0, 3)}

    def props(self, body: dict) -> dict:
        """Slate-wide prop scan over inline prop rows (the prop-sheet CSV
        schema as JSON records)."""
        games = self._games(body)
        t0 = time.perf_counter()
        with self._admit("props", t0):
            rows = self._call(
                "simulate_slate_prop_rows", games, props_csv=_frame_records(body["props"]),
                n_pairs=self._n_pairs(body, 8192),
                min_abs_edge_pct=float(body.get("min_abs_edge_pct", 0.0)),
                shard=bool(body.get("shard", self.cfg.shard)),
                seed=int(body.get("seed", 0)), **self._route_kw(self._mode(body)))
        return {"props": jsonable(_frame_records(rows)),
                "elapsed_s": round(time.perf_counter() - t0, 3)}

    def parlay(self, body: dict) -> dict:
        """Same-game parlay pricing off the joint per-trial distribution.

            POST /parlay {"team_a": "...", "team_b": "...",
                          "legs": [{"kind": "moneyline", "team": "..."},
                                   {"kind": "total", "side": "over",
                                    "line": 55.5}],
                          "n_pairs": 32768, "price": 450}

        Leg kinds: spread / moneyline / total / prop (see
        edge.resolve_parlay_legs).  Prop legs need the service to run with
        a focus csv so players are tracked.  `"correlations": true` adds
        the pairwise leg-correlation matrix under `parlay.leg_corr` (one
        record per leg, keyed by leg label, as the JAX module's DataFrame);
        `"round_robin": 2` (or a list of sizes) adds the round-robin card
        — every size-k leg combination as its own ticket — under
        `parlay.round_robin`."""
        legs = body["legs"]
        if not isinstance(legs, list) or not 0 < len(legs) <= 20:
            raise ValueError("legs must be a JSON array of 1..20 leg objects")
        price = body.get("price")
        rr = body.get("round_robin")

        def _is_size(k):  # bool is an int subclass: JSON `true` is NOT size 1
            return isinstance(k, int) and not isinstance(k, bool)

        if rr is not None and not (
                _is_size(rr)
                or (isinstance(rr, list) and rr
                    and all(_is_size(k) for k in rr))):
            raise ValueError("round_robin must be an integer ticket size or "
                             "a non-empty list of integers (e.g. 2 or [2, 3])")
        t0 = time.perf_counter()
        with self._admit("parlay", t0):
            res = self._call(
                "simulate_parlay_core", body["team_a"], body["team_b"], legs,
                n_pairs=self._n_pairs(body, 32768),
                shard=bool(body.get("shard", self.cfg.shard)),
                seed=int(body.get("seed", 0)),
                price=None if price is None else int(price),
                correlations=bool(body.get("correlations", False)),
                round_robin=rr, **self._route_kw(self._mode(body)))
        if "leg_corr" in res:
            res["leg_corr"] = corr_records(*res["leg_corr"])
        return {"parlay": jsonable(res),
                "elapsed_s": round(time.perf_counter() - t0, 3)}


def _calibration_from_body(body: dict):
    """Optional opt-in affine market calibration from a request body:
    `"calibration": {"margin_shift": -2.0, "total_shift": -15.0,
    "margin_scale": 1.0, "total_scale": 1.0}` (any subset of keys).  None
    when absent."""
    raw = body.get("calibration")
    if raw is None:
        return None
    from .edge import MarketCalibration

    if not isinstance(raw, dict):
        raise ValueError("calibration must be a JSON object of "
                         "margin/total shift/scale fields")
    allowed = {"margin_shift", "margin_scale", "total_shift", "total_scale"}
    bad = set(raw) - allowed
    if bad:
        raise ValueError(f"unknown calibration fields {sorted(bad)}; "
                         f"allowed: {sorted(allowed)}")
    vals = {k: float(v) for k, v in raw.items()}
    for k in ("margin_scale", "total_scale"):
        if vals.get(k, 1.0) <= 0:
            raise ValueError(f"{k} must be positive")
    return MarketCalibration(**vals)


def _situation_from_body(d: dict):
    """Parse one situation object from a request body — a thin dict
    adapter over api.situation_from_fields (the one shared parser, also
    behind the CLI's live/fourth commands)."""
    from .api import situation_from_fields

    return situation_from_fields(
        ytg=float(d["ytg"]), offense=d.get("offense", 0),
        sec=d.get("sec"), quarter=d.get("quarter"), clock=d.get("clock"),
        down=d.get("down", 1), dist=d.get("dist", 10.0),
        score_a=d.get("score_a", 0), score_b=d.get("score_b", 0))


_ROUTES = {"/slate": "slate", "/sim": "sim", "/props": "props",
           "/live": "live", "/parlay": "parlay", "/fourth": "fourth",
           "/season": "season"}


class _Handler(BaseHTTPRequestHandler):
    service: SimService  # injected by make_server

    # quiet by default; the service records request counts
    def log_message(self, fmt, *args):  # noqa: D102
        pass

    def _reply(self, code: int, payload: dict) -> None:
        data = json.dumps(payload).encode()
        try:
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
        except (BrokenPipeError, ConnectionResetError):
            pass  # client gave up; the sim result stays warm in the caches

    def do_GET(self):  # noqa: N802
        if self.path == "/health":
            self._reply(200, self.service.health())
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):  # noqa: N802
        name = _ROUTES.get(self.path)
        if name is None:
            self._reply(404, {"error": f"unknown path {self.path}"})
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
            if not isinstance(body, dict):
                raise ValueError("request body must be a JSON object")
        except (ValueError, json.JSONDecodeError) as e:
            self._reply(400, {"error": f"bad request body: {e}"})
            return
        try:
            self._reply(200, self.service.handle(name, body))
        except Overloaded as e:
            self._reply(503, {"error": str(e)})
        except (KeyError, ValueError, TypeError) as e:
            self._reply(400, {"error": f"{type(e).__name__}: {e}"})
        except Exception as e:  # noqa: BLE001 — surface, don't kill the server
            self._reply(500, {"error": f"{type(e).__name__}: {e}"})


class _Server(ThreadingHTTPServer):
    # the listen backlog: requests wait on the service lock, so a burst of
    # clients must queue in the kernel, not be reset as past the stdlib's 5
    request_queue_size = 128


def make_server(service: SimService, host: str = "127.0.0.1",
                port: int = 8787) -> ThreadingHTTPServer:
    """Build (but don't start) the HTTP server; port 0 picks a free port
    (`server.server_address[1]` reports it)."""
    handler = type("Handler", (_Handler,), {"service": service})
    return _Server((host, port), handler)


def serve_forever(cfg: ServeConfig, host: str = "127.0.0.1",
                  port: int = 8787, warm_games=None) -> None:
    """Serve HTTP until interrupted; in a server of several ranks rank 0
    serves and every other rank follows it (`SimService.follow`)."""
    service = SimService(cfg)
    if service.rank != 0:
        service.follow()
        return
    # bind BEFORE warming: the warm slate builds tables for seconds, and a
    # bad --warm CSV must not kill the process with the port never bound —
    # early clients connect and queue (or hit /health) while warm runs
    srv = make_server(service, host, port)
    print(f"fmc-torch serving on http://{host}:{srv.server_address[1]} "
          f"(sp={cfg.sp_path}, artifacts={cfg.artifact_dir}, "
          f"mode={cfg.mode}/{cfg.table_quality}, device={service.device})", flush=True)
    try:
        if warm_games is not None:
            try:
                print(f"warming: {service.warm(warm_games)}", flush=True)
            except Exception as e:  # noqa: BLE001 — warm is best-effort
                print(f"warm failed (serving anyway): "
                      f"{type(e).__name__}: {e}", flush=True)
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
        service.close()
