"""One run of one cell of the port's benchmark.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
deployment (``pirbench/configs/<config>.json``) and a traffic mix
(``pirbench/traffic/<mix>.json``). A run:

1. draws the store's bytes from the seed and hands them to the program
   (``repro_torch.db.RecordStore.from_bytes``), builds the program's front
   (``repro_torch.configs.pir_ct.make_async_frontend``), serves one batch of
   every bucket the mix can cut, lets the planner measure its candidates
   for them and banks the cache's precomputed plans: the set-up;
2. drives ``AsyncFrontend.submit(client, index)`` for ``seconds`` with the
   mix's lookups and keeps, for a sample of batches drawn from the seed,
   the masks the servers were sent and the answers they gave;
3. once the window has closed, waits for every lookup it sent, reads the
   peak of device memory, frees the program, and holds what came back
   to ``pirbench/reference.py`` and to the laws of the configuration's
   scheme (``pirbench/schemes/<scheme>.py``).

With ``trace`` the window runs under ``torch.profiler`` and the cell's
per-layer metrics are read from the trace by ``pirbench/metrics/*.py``;
without it the end-to-end metrics are taken by the host's clock.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import importlib.util
import json
import math
import pathlib
import threading
import time
import types
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from pirbench import reference, schemes, trace as tracing, yardstick
from pirbench.traffic import generator

ROOT = pathlib.Path(__file__).resolve().parents[1]
HERE = ROOT / "pirbench"

# how long the run waits, after the window closes, for lookups still due
GRACE_S = 60.0
# the batches whose queries and answers are kept for the reference, and
# the lookups of each
KEEP_BATCHES = 4
KEEP_COLUMNS = 2
# the limit of a number ``correct`` compares where the configuration's
# ``limits`` states none (each one stated is the configuration's)
DEFAULT_LIMITS = {"delta_gap": 1e-6}
# the limits each wire kind needs stated
KIND_LIMITS = {"mask": ("density_z", "eps_gap"),
               "index": ("dummies_z", "eps_gap")}

# keys of a configuration file that describe it and are not handed to the
# program; every other key has to name a field of the program's PIRConfig
META_KEYS = ("source", "reduced", "assumed", "guarantees", "limits",
             "control")


# ------------------------------------------------------------------ cells
@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(workload: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell ``workload`` of ``<root>/BENCHMARK.json`` with its
    configuration, its mix and the metrics it reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; have {sorted(cells)}")
    w = cells[workload]
    files = {c["name"]: c["file"] for c in bench["configs"]}
    config = json.loads((root / files[w["config"]]).read_text())
    mix = generator.load_mix(w["traffic"], root / "pirbench" / "traffic")
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if workload in m.get("workloads", [workload])
                 and m["moves"] in reported]
    return Cell(workload, int(w["chips"]), config, mix, e2e, per_layer)


def metric_reader(name: str, root: pathlib.Path = HERE / "metrics"
                  ) -> Callable:
    """The ``read(ctx)`` of ``metrics/<name>.py``, else of the file of the
    name's first part (``plan_device_ms.online`` -> ``plan_device_ms.py``:
    one reader, its number split by the end-to-end metric it moves)."""
    for stem in (name, name.split(".")[0]):
        path = root / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                f"pirbench_metric_{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for metric {name!r} under {root}")


def pir_config(config: dict, mix: dict, overrides: Optional[dict] = None):
    """The program's PIRConfig for a deployment under a mix: every key of
    the configuration file but ``META_KEYS``, each a field of PIRConfig
    (any other key is refused, never dropped); the mix's bucket cap bounds
    the deployment's."""
    from repro_torch.configs.base import PIRConfig

    fields = {f.name for f in dataclasses.fields(PIRConfig)}
    kw = {k: v for k, v in config.items() if k not in META_KEYS}
    unknown = sorted(set(kw) - fields)
    if unknown:
        raise KeyError(f"configuration {config.get('name')!r}: {unknown} "
                       f"name no field of PIRConfig")
    kw.update(overrides or {})
    kw["query_batch"] = min(int(config["query_batch"]), int(mix["bucket_cap"]))
    return PIRConfig(**kw)


def buckets(cap: int) -> List[int]:
    """Every bucket the scheduler can cut under ``cap`` (powers of two,
    and the cap)."""
    out, b = [], 1
    while b < cap:
        out.append(b)
        b *= 2
    return out + [cap]


# --------------------------------------------------------------- lookups
class Lookup:
    """One lookup the benchmark sent: when it was due, when it went out,
    when its future resolved, and with what."""

    __slots__ = ("client", "index", "due", "sent", "done", "future", "shed")

    def __init__(self, client: str, index: int, due: float):
        self.client, self.index, self.due = client, index, due
        self.sent = self.done = math.nan
        self.future = None
        self.shed = False

    def resolved(self, _fut) -> None:
        self.done = time.perf_counter()

    def answer(self) -> Optional[np.ndarray]:
        """The record bytes, or None when the lookup was shed, failed or
        never came back."""
        if self.shed or self.future is None or not self.future.done():
            return None
        if self.future.cancelled() or self.future.exception() is not None:
            return None
        return self.future.result()


def _send(fe, rec: Lookup) -> Lookup:
    from repro_torch.serve.frontend import BackpressureError

    rec.sent = time.perf_counter()
    try:
        rec.future = fe.submit(rec.client, rec.index)
    except BackpressureError:
        rec.shed = True
        return rec
    rec.future.add_done_callback(rec.resolved)
    return rec


def open_loop(fe, schedule: generator.OpenSchedule, t0: float
              ) -> List[Lookup]:
    """Send each lookup at its time after ``t0``, whatever has come back."""
    sent = []
    for t, (client, index) in zip(schedule.times, schedule.lookups):
        due = t0 + float(t)
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        sent.append(_send(fe, Lookup(client, index, due)))
    return sent


def closed_loop(fe, mix: dict, n: int, seed: int, seconds: float,
                on_open: Callable[[], None]) -> tuple:
    """Keep ``outstanding`` consecutive lookups in flight; the window opens
    once ``preroll`` have come back. Returns (lookups, t_open)."""
    start = generator.closed_offset(mix, n, seed)
    clients = [f"monitor{i}" for i in range(int(mix["clients"]))]
    sent: List[Lookup] = []
    pending: collections.deque = collections.deque()

    def send():
        k = len(sent)
        rec = Lookup(clients[k % len(clients)], (start + k) % n,
                     time.perf_counter())
        sent.append(_send(fe, rec))
        pending.append(rec)

    for _ in range(int(mix["outstanding"])):
        send()
    back, t_open, t_close = 0, None, math.inf
    while pending:
        rec = pending[0]
        if rec.future is not None:
            wait = min(GRACE_S, t_close - time.perf_counter())
            try:
                rec.future.result(timeout=max(0.0, wait))
            except TimeoutError:
                if time.perf_counter() >= t_close:
                    break  # the window closes on time; the rest is drained
            except Exception:  # judged with the others after the window
                pass
        pending.popleft()
        back += 1
        if t_open is None and back >= int(mix["preroll"]):
            on_open()
            t_open = time.perf_counter()
            t_close = t_open + seconds
        if time.perf_counter() >= t_close:
            break
        send()
    return sent, t_open


# ---------------------------------------------------------------- probes
class Probe:
    """The benchmark's wrappers around the program's layers (instance
    attributes over the pipeline's and the backend's methods; the program
    calls them through ``self``).

    Always: for a sample of the batches answered while armed (a reservoir
    drawn from the seed), the servers it contacted, the queries of a few
    of its lookups (their masks, or their record ids) and every server's
    answers to them are copied aside, into buffers made, and a copy
    rehearsed, on the first batch it sees before it is armed: the set-up's,
    so that nothing is allocated, uploaded or loaded for the copies
    inside the window (an allocation there stalled the window's first
    batch by 0.3 to 0.6 s on an H100). With ``ranges``: each call of a
    layer that a reader of ``metrics/`` reads (the plan and the answers)
    runs in a ``record_function`` range ``pirbench.<layer>#k``, and each
    answered batch's shape (an index batch: its ids) is noted for the
    least time its answers need."""

    def __init__(self, pipe, seed: int, ranges: bool):
        self.pipe = pipe
        self.ranges = ranges
        self.rng = np.random.default_rng([seed & 0xFFFFFFFFFFFFFFFF, 3])
        self.armed = False
        self.seen = 0
        self.kept: List[dict] = []
        # KEEP_BATCHES (queries, answers) buffers of KEEP_COLUMNS lookups
        self.slots: Optional[List[tuple]] = None
        self.shapes: Dict[int, dict] = {}
        self.buckets: collections.Counter = collections.Counter()
        self._tls = threading.local()
        self._seq = collections.Counter()
        self._lock = threading.Lock()
        backend = pipe.backend
        self._answer = backend.answer_batch
        self._execute = pipe.execute_planned
        backend.answer_batch = self.answer_batch
        pipe.execute_planned = self.execute_planned
        if ranges:
            pipe.plan_requests = self._ranged(pipe.plan_requests, "plan")

    def _next(self, layer: str) -> int:
        with self._lock:
            k = self._seq[layer]
            self._seq[layer] += 1
        return k

    def _ranged(self, fn, layer):
        from torch.profiler import record_function

        def wrapped(*a, **kw):
            with record_function(f"{tracing.PREFIX}{layer}#{self._next(layer)}"):
                return fn(*a, **kw)
        return wrapped

    def execute_planned(self, planned):
        self._tls.planned = planned
        try:
            return self._execute(planned)
        finally:
            self._tls.planned = None

    def answer_batch(self, routed, **kw):
        if self.ranges:
            from torch.profiler import record_function

            seq = self._next("answer")
            with record_function(f"{tracing.PREFIX}answer#{seq}"):
                responses = self._answer(routed, **kw)
            if routed.kind == "mask":
                m = routed.payload  # [servers, bucket, n]
                self.shapes[seq] = {
                    "servers": int(m.shape[0]), "bucket": int(m.shape[1]),
                    "n": int(m.shape[2])}
            elif routed.kind == "index":
                # [servers, bucket, p/d] ids: counted once the window closed
                self.shapes[seq] = {"ids": routed.payload}
        else:
            responses = self._answer(routed, **kw)
        planned = getattr(self._tls, "planned", None)
        live = (len(planned.misses) if planned is not None
                else int(routed.payload.shape[1]))
        if self.armed:
            self.buckets[int(routed.payload.shape[1])] += 1
            self._offer(routed, responses, planned, live)
        elif self.slots is None:
            self.slots = [_columns_like(routed.payload, responses)
                          for _ in range(KEEP_BATCHES)]
            queries, answers = self.slots[0]
            queries[:, 0].copy_(routed.payload[:, 0])
            answers[:, 0].copy_(responses[:, 0])
        return responses

    def _offer(self, routed, responses, planned, live: int) -> None:
        if live < 1:
            return
        self.seen += 1
        if len(self.kept) < KEEP_BATCHES:
            slot = len(self.kept)
        else:
            slot = int(self.rng.integers(self.seen))
            if slot >= KEEP_BATCHES:
                return
        cols = np.sort(self.rng.choice(live, size=min(KEEP_COLUMNS, live),
                                       replace=False))
        if planned is not None:
            indices = [int(planned.misses[c].index) for c in cols]
        else:
            idx = torch.as_tensor(cols, device=routed.payload.device)
            indices = [int(i) for i in routed.q_idx[idx].cpu()]
        queries, answers = self.slots[slot]
        for j, c in enumerate(cols):
            queries[:, j].copy_(routed.payload[:, int(c)])
            answers[:, j].copy_(responses[:, int(c)])
        entry = {"indices": indices,
                 "servers": tuple(int(s) for s in routed.servers),
                 "queries": queries[:, :len(cols)],
                 "answers": answers[:, :len(cols)]}
        if slot == len(self.kept):
            self.kept.append(entry)
        else:
            self.kept[slot] = entry

    def least_s(self, words: int, config: dict) -> Dict[int, float]:
        """The least time each traced batch's answers need. The records a
        server's masks select are counted as the configuration's scheme
        draws them (``reference.weight_moments`` under the scheme's laws;
        ``density_z`` holds the masks the run kept to that draw), not from
        the masks themselves: counting 12.8 GB of masks a batch would take
        the card longer than some of the answers do. An index batch's ids
        are few: each server's distinct ones are counted."""
        laws = schemes.laws(config["scheme"])
        if laws.kind == "index":
            least = {}
            for seq, c in self.shapes.items():
                ids = c["ids"].cpu().numpy()
                ids = np.sort(ids.reshape(ids.shape[0], -1), axis=1)
                distinct = 1 + (np.diff(ids, axis=1) != 0).sum(axis=1)
                least[seq] = sum(yardstick.gather_s(ids.shape[1], words,
                                                    int(m)) for m in distinct)
            return least
        servers = laws.servers(config)
        mean, _ = reference.weight_moments(laws.density(config), servers,
                                           odd=False)
        p = mean / servers
        return {seq: c["servers"] * yardstick.answer_s(
                    c["n"], words, c["bucket"], p)
                for seq, c in self.shapes.items()}


def _columns_like(queries, answers) -> tuple:
    """Device buffers for KEEP_COLUMNS lookups of a batch whose queries and
    answers are shaped [servers, bucket, ...] like these."""
    return tuple(torch.empty((t.shape[0], KEEP_COLUMNS, *t.shape[2:]),
                             dtype=t.dtype, device=t.device)
                 for t in (queries, answers))


# ------------------------------------------------------------------ set-up
def warm(pipe, cap: int, n: int) -> None:
    """Serve one batch of every bucket the mix can cut, let the planner
    measure its candidates for each, serve each once more on the chosen
    kernels, and bank the cache's precomputed plans."""
    from repro_torch._device import synchronize

    def serve_all(offset):
        # fresh indices each pass: a repeat would come from the cache
        for b in buckets(cap):
            for j in range(b):
                pipe.submit_request("warmup", (offset + j * 7919) % n)
            pipe.serve_requests(pipe.take_batch())
            offset += 7919 * b

    serve_all(0)
    pipe.backend.tune_pending()
    serve_all(n // 2)
    if pipe.cache is not None:
        while pipe.prefill_cache():
            pass
    synchronize(pipe.device)


def warm_front(fe, cap: int, n: int) -> None:
    """Send a burst of every bucket's size through the started front and
    wait for each, then for the front's idle slot to bank the plans the
    bursts took: its threads, its side stream and what they allocate come
    up in the set-up, not in an open loop's window (a closed loop's
    preroll does the same)."""
    offset = n // 4
    for b in buckets(cap):
        futures = [fe.submit("warmup", (offset + j * 7919) % n)
                   for j in range(b)]
        offset += 7919 * b
        for f in futures:
            f.result(timeout=GRACE_S)
    fe.drain(timeout=GRACE_S)
    banked, settled = fe.metrics.get("prefilled"), time.perf_counter()
    while time.perf_counter() - settled < 0.05:
        time.sleep(0.01)
        now = fe.metrics.get("prefilled")
        if now != banked:
            banked, settled = now, time.perf_counter()


# ---------------------------------------------------------------- judging
def percentile(values: List[float], q: float) -> float:
    """The ``q``-th percentile with numpy's linear rule, where a missing
    lookup counts at infinite latency (never dropped)."""
    v = sorted(values)
    if not v:
        return math.nan
    pos = (len(v) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    if lo == hi or v[lo] == v[hi]:
        return v[lo]
    if math.isinf(v[hi]):
        return math.inf
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def limits(config: dict, kind: str) -> Dict[str, float]:
    """The limits of a configuration's numbers: its ``limits``, with
    ``DEFAULT_LIMITS`` where it states none; a KeyError where it leaves
    out one that its scheme's wire ``kind`` needs."""
    stated = dict(config.get("limits", {}))
    missing = [k for k in KIND_LIMITS[kind] if k not in stated]
    if missing:
        raise KeyError(f"configuration {config.get('name')!r} states no "
                       f"limit for {missing}")
    return {**DEFAULT_LIMITS, **{k: float(v) for k, v in stated.items()}}


def _judge_masks(kept, laws, config, raw_words, nbytes, device) -> dict:
    """What a mask scheme's kept queries show: each server's answer
    against the XOR of the rows its mask selects, each query's masks
    folding to its index, and the ones they set against the law's
    density over their own number of servers."""
    n = int(config["n_records"])
    checked = errors = parity_errors = 0
    ones = 0.0
    queries: collections.Counter = collections.Counter()  # by servers
    for entry in kept:
        masks = entry["queries"].to(device)
        got = reference.answer_bytes(entry["answers"].to(device), nbytes)
        for j, index in enumerate(entry["indices"]):
            q = reference.judge_query(masks[:, j], index)
            parity_errors += not q["parity_ok"]
            ones += q["ones"]
            queries[int(masks.shape[0])] += 1
            want = reference.server_answers(raw_words, masks[:, j])
            errors += int((want != got[:, j]).any(dim=1).sum())
            checked += int(want.shape[0])
    return {"checked": checked, "errors": errors,
            "parity_errors": parity_errors,
            "density_z": reference.density_z(queries, laws.density(config),
                                             n, ones)}


def _judge_requests(kept, laws, config, raw, nbytes, device) -> dict:
    """What an index scheme's kept lookups show: each lookup's p ids
    distinct, split p/d a server and holding its index once; each row
    returned equal to the store's; the dummies' sum against the uniform
    draw from the other records."""
    n, d = int(config["n_records"]), int(config["d"])
    p, per = laws.requests(config), laws.per_server(config)
    raw_t = torch.from_numpy(raw).to(device)
    checked = errors = request_errors = 0
    total, mean, var = 0.0, 0.0, 0.0
    for entry in kept:
        reqs = entry["queries"].to(device).long()  # [servers, cols, p/d]
        got = reference.answer_bytes(entry["answers"].to(device), nbytes)
        for j, index in enumerate(entry["indices"]):
            ids = reqs[:, j].reshape(-1)
            inside = (ids >= 0) & (ids < n)
            request_errors += not (
                tuple(reqs.shape[::2]) == (d, per) and ids.numel() == p
                and bool(inside.all())
                and int(torch.unique(ids).numel()) == ids.numel()
                and int((ids == index).sum()) == 1)
            want = raw_t.index_select(0, ids.clamp(0, n - 1))
            wrong = (want != got[:, j].reshape(-1, nbytes)).any(dim=1)
            errors += int((wrong | ~inside).sum())
            checked += int(ids.numel())
            dummies = ids[ids != index]
            total += float(dummies.sum())
            m, v = reference.dummy_moments(n, index, int(dummies.numel()))
            mean += m
            var += v
    z = reference.z_score(total, mean, var) if checked else math.inf
    return {"checked": checked, "errors": errors,
            "request_errors": request_errors, "dummies_z": z}


def judge(raw: np.ndarray, sent: List[Lookup], good: set, kept: List[dict],
          charged: Dict[str, tuple], config: dict, device) -> dict:
    """Every number the run's ``correct`` rests on, each with its limit
    (``pirbench/configs/<config>.json`` ``limits``, else
    ``DEFAULT_LIMITS``). ``good`` holds the ids of the lookups that came
    back with their record's bytes. The scheme's laws
    (``pirbench/schemes/<scheme>.py``) say what its queries are and what
    a lookup costs."""
    laws = schemes.laws(config["scheme"])
    lim = limits(config, laws.kind)
    nbytes = raw.shape[1]
    d = int(config["d"])
    want_servers = laws.servers(config)
    server_errors = 0
    for entry in kept:
        ids = entry["servers"]
        server_errors += not (
            len(ids) == want_servers == int(entry["queries"].shape[0])
            and len(set(ids)) == len(ids) and all(0 <= s < d for s in ids))
    if laws.kind == "mask":
        raw_words = reference.word_view(torch.from_numpy(raw).to(device))
        seen = _judge_masks(kept, laws, config, raw_words, nbytes, device)
        del raw_words
        own = {"parity_errors": (seen["parity_errors"], 0, "<="),
               "density_z": (seen["density_z"], lim["density_z"], "<=")}
    else:
        seen = _judge_requests(kept, laws, config, raw, nbytes, device)
        own = {"request_errors": (seen["request_errors"], 0, "<="),
               "dummies_z": (seen["dummies_z"], lim["dummies_z"], "<=")}
    eps_ref, delta_ref = laws.privacy(config)
    count = collections.Counter(r.client for r in sent if not r.shed)
    eps_gap = delta_gap = 0.0
    for client, k in count.items():
        eps, delta = charged[client]
        eps_gap = max(eps_gap, _relative_gap(eps, k * eps_ref))
        delta_gap = max(delta_gap, _relative_gap(delta, k * delta_ref))
    checks = {
        "lookup_errors": (len(sent) - len(good), 0, "<="),
        "answers_checked": (seen["checked"], 1, ">="),
        "answer_errors": (seen["errors"], 0, "<="),
        "server_errors": (server_errors, 0, "<="),
        **own,
        "eps_gap": (eps_gap, lim["eps_gap"], "<="),
        "delta_gap": (delta_gap, lim["delta_gap"], "<="),
    }
    return {k: {"value": v, "limit": l, "rule": r}
            for k, (v, l, r) in checks.items()}


def _relative_gap(charged: float, want: float) -> float:
    """|charged − want| ÷ want; where want is 0, 0 if nothing was charged
    and ∞ otherwise."""
    if want > 0:
        return abs(charged - want) / want
    return 0.0 if charged == 0 else math.inf


def passed(checks: dict) -> bool:
    for c in checks.values():
        v, lim = c["value"], c["limit"]
        ok = v <= lim if c["rule"] == "<=" else v >= lim
        if not ok or (isinstance(v, float) and math.isnan(v)):
            return False
    return True


# --------------------------------------------------------------------- run
def unlimited_budget():
    """A client's privacy budget with no limit on ε or δ."""
    from repro_torch.core.accounting import PrivacyBudget

    return PrivacyBudget(epsilon_limit=math.inf, delta_limit=math.inf)


def set_up(cell: Cell, seed: int, dev: torch.device, trace: bool,
           overrides: Optional[dict] = None,
           log: Callable[[str], None] = lambda s: None) -> tuple:
    """The store's bytes, the program's store and started front over them,
    warmed, with the probe installed: (raw, store, front, probe)."""
    from repro_torch.configs.pir_ct import make_async_frontend
    from repro_torch.db import RecordStore

    config = cell.config
    n, nbytes = int(config["n_records"]), int(config["record_bytes"])
    pcfg = pir_config(config, cell.mix, overrides)
    # a scheme the reference cannot judge, or a configuration that leaves
    # out what its laws or its limits need, is refused before any work
    laws = schemes.laws(config["scheme"])
    laws.privacy(config)
    laws.servers(config)
    limits(config, laws.kind)
    raw = reference.store_bytes(n, nbytes, seed)
    store = RecordStore.from_bytes(raw, device=dev)
    # no client runs out of budget: the charge itself is what is judged
    fe = make_async_frontend(pcfg, store=store, device=dev, seed=seed,
                             default_budget=unlimited_budget)
    probe = Probe(fe.pipeline, seed, ranges=trace)
    warm(fe.pipeline, pcfg.query_batch, n)
    log("planner: " + "; ".join(
        f"{key[1] if len(key) > 1 else key} -> {e['path']} {e['blocks']} "
        f"({ {k: round(v) for k, v in e['us'].items()} } us)"
        for key, e in fe.pipeline.backend.planner.table.items()))
    fe.start()
    if cell.mix["loop"] == "open":
        warm_front(fe, pcfg.query_batch, n)
    return raw, store, fe, probe


def run(cell: Cell, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", started: Optional[float] = None,
        overrides: Optional[dict] = None, log: Callable[[str], None] = lambda s: None) -> dict:
    """One run of ``cell``; returns the result object (see ``run.py``).
    ``overrides`` replaces configuration fields in the program only (the
    control); the reference keeps the configuration as stated."""
    started = time.perf_counter() if started is None else started
    dev = torch.device(device)
    config, mix = cell.config, cell.mix
    n = int(config["n_records"])
    raw, store, fe, probe = set_up(cell, seed, dev, trace, overrides, log)
    pipe = fe.pipeline

    prof = window = None
    if trace:
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile, record_function

        # every thread: the front plans and answers on threads of its own
        prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else []),
            experimental_config=_ExperimentalConfig(profile_all_threads=True))
        window = record_function(tracing.WINDOW)
    counters: Dict[str, Dict[str, float]] = {}

    def open_window():
        probe.armed = True
        counters["open"] = dict(pipe.metrics)
        if trace:
            prof.__enter__()
            window.__enter__()

    def close_window():
        counters["close"] = dict(pipe.metrics)
        if trace:
            window.__exit__(None, None, None)
            prof.__exit__(None, None, None)

    if mix["loop"] == "open":
        schedule = generator.open_schedule(mix, n, seconds, seed)
        setup_s = time.perf_counter() - started
        open_window()
        t0 = time.perf_counter()
        sent = open_loop(fe, schedule, t0)
        rest = t0 + seconds - time.perf_counter()
        if rest > 0:
            time.sleep(rest)
        close_window()
    else:
        t_setup = []

        def on_open():
            t_setup.append(time.perf_counter() - started)
            open_window()

        sent, t0 = closed_loop(fe, mix, n, seed, seconds, on_open)
        close_window()
        setup_s = t_setup[0]
    t_close = time.perf_counter()

    deadline = t_close + GRACE_S
    for rec in sent:
        if rec.future is not None:
            try:
                rec.future.result(timeout=max(0.0, deadline - time.perf_counter()))
            except Exception:  # a failed lookup is judged below
                pass
    fe.close(drain=False)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    charged = {c: (pipe.budget(c).spent_epsilon, pipe.budget(c).spent_delta)
               for c in {r.client for r in sent}}
    delta = {k: counters["close"][k] - counters["open"].get(k, 0)
             for k, v in counters["close"].items()
             if isinstance(v, (int, float))}
    least = probe.least_s(store.words, config) if trace else {}
    good = {id(r) for r in sent if r.answer() is not None
            and np.array_equal(np.asarray(r.answer()), raw[r.index])}
    kept, bucket_hist, seen = probe.kept, dict(probe.buckets), probe.seen
    lateness = [r.sent - r.due for r in sent]
    log(f"window: {len(sent)} lookups sent, batches answered by bucket "
        f"{dict(sorted(bucket_hist.items()))}, sender late p50 "
        f"{1e3 * percentile(lateness, 50):.3f} ms / max "
        f"{1e3 * max(lateness, default=0.0):.3f} ms, counters {delta}")
    del fe, pipe, probe, store
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()

    result: dict = {}
    if trace:
        tr = tracing.reduce_profile(prof)
        del prof
        ctx = types.SimpleNamespace(trace=tr, counters=delta,
                                    answer_least=least, cell=cell,
                                    latencies=latencies(cell, sent, good))
        metrics = {}
        for m in cell.per_layer:
            v = metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        busy = {"busy_s": tr.busy_s, "window_s": tr.window_s}
        result["breakdown"] = {"device_ops": tr.top_ops(10),
                               "idle_gaps": tr.idle_gaps(10)}
        log(f"trace: {len(tr.ops)} device operations, {tr.unlinked} with no "
            f"launch found, {len(tr.ranges)} ranges")
    else:
        metrics = e2e_metrics(cell, sent, good, t0, seconds, setup_s, log)
        busy = {}

    checks = judge(raw, sent, good, kept, charged, config, dev)
    log(f"checked {len(kept)} of the {seen} batches answered in the window")
    result.update({
        "correct": passed(checks),
        "attempted": len(sent),
        "failed": len(sent) - len(good),
        "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak), **busy},
    })
    result["limits"] = checks
    return result


def latencies(cell: Cell, sent: List[Lookup], good: set
              ) -> Optional[List[float]]:
    """Each lookup's seconds from its scheduled arrival to its record, by
    the host's clock (infinite for one that did not come back with it); None
    for a closed loop, whose lookups have no schedule."""
    if cell.mix["loop"] != "open":
        return None
    return [(r.done - r.due) if id(r) in good else math.inf for r in sent]


def e2e_metrics(cell: Cell, sent: List[Lookup], good: set, t0: float,
                seconds: float, setup_s: float,
                log: Callable[[str], None] = lambda s: None) -> dict:
    """The end-to-end metrics the cell reports, by the host's clock. A
    lookup that did not come back with its record counts as missing every
    limit: at infinite latency, and not among those answered."""
    t1 = t0 + seconds
    values = {"setup_s": setup_s}
    lat = latencies(cell, sent, good)
    if lat is not None:
        values["lookup_p50_ms"] = 1e3 * percentile(lat, 50)
        values["lookup_p95_ms"] = 1e3 * percentile(lat, 95)
    ok = [r for r in sent if id(r) in good and t0 <= r.done <= t1]
    values["lookups_per_s"] = len(ok) / seconds
    log(f"host clock, the cell's and the others: {values}")
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end}
