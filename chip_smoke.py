#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths through the serving pipeline at the size of the
paper's own workload (10^6 records of 1536 bytes, d = 100 databases,
Sparse-PIR at θ = 0.25 and Chor): one private lookup, Chor in buckets of
128 on the planner's own fold/parity choice (the parity path on the int8
tensor cores), serving a live store that takes update, delete and append
deltas, and multi-index requests; the paper's other schemes on the same
store (Direct Requests with p = d, Subset-PIR among t = d_a + 1 replicas
picked by the pipeline's latency ranking, Sparse-PIR through an anonymity
set of u = 1000), the cross-batch cache (hits, a banked precompute) and
the measured planner (the autotune search of a sparse and a Chor cell,
its table saved, reloaded, and a foreign one dropped). Between the kernel
checks and the paths,
the fold is timed against the parity path across scheduler buckets at n
cut to 65 536 and at the full 10^6 (phase ``crossover``). Then the
attention models at full width: SmolLM-135M serving (prefill and
greedy decode of 4 x 4096 tokens, one 32 768-token prefill, the f32 model
on the card against the CPU) and BERT4Rec scoring 32 users whose item
histories are fetched by Sparse-PIR. Builds the CUDA kernels from the
nine sources in this tree (flash attention has two: bf16 at head dims 64
and 128 on wgmma, everything else on the TF32 tensor cores through
mma.sync in three passes; the Sparse-PIR index compaction in front of the
gather has one), holds each against its
plain PyTorch version on the card (bit for bit for the six GF(2) kernels
and the compaction, PIR is exact; within the reference's float tolerance
for flash attention), times them with CUDA events (the gather at batches
of 8, 32 and 1, on ascending ids and on shuffled ones; the fused gathers
at batches of 8 and 32 in both grid orders and both staging paths, with
the card's own time from torch.profiler), and checks that
the answers are right (stored or pinned records; finite logits that
agree with the CPU; private logits equal to the plain ones bit for bit)
and that each path went through its kernels (launch counters, set to 0
before a path and read after it). One JSON line per phase; the last line
is the verdict.

Needs a CUDA device and ``nvcc``; exits non-zero without printing a verdict
when there is no device. Imports only ``repro_torch``.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published peaks of one H100 SXM (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_FLOPS_PER_S = 989e12  # tensor cores
TF32_FLOPS_PER_S = 494.7e12  # tensor cores
F32_FLOPS_PER_S = 67e12    # outside the tensor cores

# flash attention against its plain version: in bf16 both sides accumulate
# in f32 and round once to bf16, so they differ by at most one bf16 ulp
# (2^-8 to 2^-7 of the value) plus f32 noise
FLASH_TOL = {torch.float32: {"rtol": 1e-5, "atol": 1e-5},
             torch.bfloat16: {"rtol": 8e-3, "atol": 1e-3}}

CSRC = "src/repro_torch/kernels/csrc/"

FLASH_SOURCES = {"flash_fwd_kernel": "flash_attention.cu",
                 "flash_wgmma_kernel": "flash_attention_wgmma.cu"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, warmup: int = 2, iters: int = 10) -> float:
    """Mean milliseconds of ``fn`` over ``iters`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest absolute difference of two integer tensors (0 = bit-equal)."""
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def random_mask(rng, q: int, n: int, density: float, device) -> torch.Tensor:
    m = rng.random((q, n), dtype=np.float32) < density
    return torch.from_numpy(m.astype(np.uint8)).to(device)


def check_kernel(name, shape, kernel_fn, plain_fn, bound, source, replaces,
                 library_fn=None, iters=10, plain_iters=2, also=None):
    """Compare one kernel with its plain version and time both; ``also``
    takes the plain answer and returns more keys of the row."""
    got = kernel_fn()
    want = plain_fn()
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err != 0:
        raise AssertionError(f"{name} {shape}: kernel differs from the plain "
                             f"version (max abs err {err}, tolerance 0)")
    extra = also(want) if also is not None else {}
    del got, want
    bound_ms, bound_by = bound
    row = {
        "name": name, "route": "cuda", "source": CSRC + source,
        "replaces": replaces, "shape": shape, "launches": 0,
        "max_abs_err": err, "tolerance": 0,
        "ms": time_ms(kernel_fn, iters=iters),
        "plain_ms": time_ms(plain_fn, warmup=1, iters=plain_iters),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": (
            None if library_fn is None else time_ms(library_fn, iters=3)
        ),
        **extra,
    }
    return row


def fold_forms(db, mask, want, iters=10):
    """Each form of xor_fold.cu, forced through the wrapper's private launch
    helper, held bit for bit against the plain answer ``want`` and timed;
    with the form the wrapper picks at this batch."""
    import importlib

    fold = importlib.import_module("repro_torch.kernels.xor_fold")
    forms = {}
    for form in fold.FORMS:
        err = max_abs_err(fold._launch(db, mask, form), want)
        if err != 0:
            raise AssertionError(f"xor_fold {form} form at q={mask.shape[0]} "
                                 f"differs from the plain version ({err})")
        forms[form] = {"max_abs_err": err, "ms": time_ms(
            lambda: fold._launch(db, mask, form), iters=iters)}
    return {"form": fold._form_for(mask.shape[0]), "forms": forms}


def fold_switch_sweep(db, rng, dev, batches):
    """The streaming form and the table form at each of its warp widths on
    the CT store at density-0.5 masks of each batch size, held equal to
    each other: where the wrapper's switches (``TABLE_MIN_QUERIES``,
    ``TABLE_WIDE_MIN_QUERIES``) stand."""
    import importlib

    fold = importlib.import_module("repro_torch.kernels.xor_fold")
    runs = {fold.STREAM: (fold.STREAM, None), **{
        f"{fold.TABLE}_qw{qw}": (fold.TABLE, qw) for qw in fold.TABLE_WIDTHS}}
    sweep = []
    for q in batches:
        mask = random_mask(rng, q, db.shape[0], 0.5, dev)
        first = fold._launch(db, mask, fold.STREAM)
        for name, (form, qw) in runs.items():
            err = max_abs_err(fold._launch(db, mask, form, qw), first)
            if err != 0:
                raise AssertionError(f"xor_fold {name} differs from the "
                                     f"streaming form at q={q} ({err})")
        del first
        sweep.append({
            "q": q, "form": fold._form_for(q),
            "table_qw": fold._table_width(q), **{
                name + "_ms": time_ms(
                    lambda: fold._launch(db, mask, form, qw), iters=5)
                for name, (form, qw) in runs.items()}})
        del mask
    return {"table_min_queries": fold.TABLE_MIN_QUERIES,
            "table_wide_min_queries": fold.TABLE_WIDE_MIN_QUERIES,
            "batches": sweep}


def serve_live(pir_ct, cfg, base, dev, rng, pir_delta_batch, Delta,
               VersionedStore, scatter_rows, scatter_ms):
    """A live CT store: a flush, a 1 % update burst (3 scatter launches),
    reads of updated rows, a batch pinned across a further update, a
    delete, an append and a checked compaction."""
    n, rb, d = base.n, cfg.record_bytes, cfg.d
    live = VersionedStore(base, shards=8)
    pipe = pir_ct.make_serving_pipeline(cfg, store=live, device=dev, seed=5)
    planner = pipe.backend.planner
    torch.cuda.reset_peak_memory_stats()
    flush_s, ingest_s = [], {}

    def flush(picks):
        for c, i in enumerate(picks):
            if not pipe.submit(f"client-{c}", int(i)):
                raise AssertionError("budget refused a query")
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = pipe.flush()
        torch.cuda.synchronize()
        flush_s.append(time.perf_counter() - t)
        head = live.snapshot()
        for c, i in enumerate(picks):
            if not np.array_equal(out[f"client-{c}"],
                                  head.record_bytes(int(i))):
                raise AssertionError(f"serve_live_ct: wrong record {int(i)}")
        return out

    def ingest(label, delta):
        torch.cuda.synchronize()
        t = time.perf_counter()
        pipe.ingest(delta)
        torch.cuda.synchronize()
        ingest_s[label] = time.perf_counter() - t

    # 1. plans exist
    flush(rng.integers(0, n, size=8))
    kept0 = planner.metrics["plans_kept"]
    dropped0 = planner.metrics["plans_dropped"]
    # 2. a 1 % update burst: three chunks of at most 4096 rows
    (burst,) = pir_delta_batch(n, rb, updates=10_000, seed=2, step=0)
    before = scatter_rows.launches
    ingest("update_10000", burst)
    burst_launches = scatter_rows.launches - before
    if burst_launches != 3:
        raise AssertionError(
            f"the 10 000-row update launched scatter_rows {burst_launches} "
            "times, expected 3")
    if not (planner.metrics["plans_kept"] > kept0
            and planner.metrics["plans_dropped"] == dropped0):
        raise AssertionError(f"update did not keep the plans: "
                             f"{planner.metrics}")
    swap_after_update = dict(pipe.backend.last_swap)
    # 3. updated rows read back their new bytes
    updated = burst.indices[:4]
    changed = sum(not np.array_equal(base.record_bytes(int(i)),
                                     live.snapshot().record_bytes(int(i)))
                  for i in updated)
    if changed == 0:
        raise AssertionError("the update burst changed none of its rows")
    flush(np.concatenate([updated, rng.integers(0, n, size=4)]))
    # 4. a batch planned before a further update answers its pinned bytes
    j = int(rng.integers(0, n))
    pinned_bytes = live.snapshot().record_bytes(j)
    if not pipe.submit("pinned", j):
        raise AssertionError("budget refused a query")
    planned = pipe.plan_requests(pipe.take_batch())
    fresh = rng.integers(0, 256, size=(1, rb), dtype=np.uint8)
    ingest("update_pinned", Delta.update([j], fresh))
    answer = dict((r.client, a) for r, a in pipe.execute_planned(planned))
    if not np.array_equal(answer["pinned"], pinned_bytes):
        raise AssertionError("a pinned batch did not answer its snapshot")
    if np.array_equal(answer["pinned"], fresh[0]):
        raise AssertionError("the pinned batch saw the later write")
    # 5. tombstones
    (tomb,) = pir_delta_batch(n, rb, deletes=100, seed=2, step=1)
    ingest("delete_100", tomb)
    out = flush(np.concatenate([tomb.indices[:2], rng.integers(0, n, size=6)]))
    if out["client-0"].any() or out["client-1"].any():
        raise AssertionError("a deleted record is not zero")
    # 6. an append of --ingest-rows records; the price is re-read
    (grow,) = pir_delta_batch(n, rb, appends=64, seed=2, step=2)
    ingest("append_64", grow)
    if live.n != n + 64 or pipe.store.n != n + 64:
        raise AssertionError("the append did not grow the store")
    if pipe.price != pipe.staged.privacy(n + 64):
        raise AssertionError("the price was not re-read at the new n")
    out = flush([n + 7] + list(rng.integers(0, n, size=7)))
    if not np.array_equal(out["client-0"], grow.raw[7]):
        raise AssertionError("appended record n + 7 is not served exactly")
    # 7. compaction: the host replay must equal the head bit for bit
    torch.cuda.synchronize()
    t = time.perf_counter()
    compacted = pipe.compact_step()
    compact_s = time.perf_counter() - t
    if compacted != 4 or live.log_depth != 0:
        raise AssertionError(f"compaction folded {compacted} deltas")
    emit({
        "phase": "serve_live_ct", "scheme": cfg.scheme, "n": n,
        "n_after": live.n, "record_bytes": rb, "d": d, "batch": 8,
        "shards": live.shards, "version": live.version,
        "flush_s": flush_s, "ingest_s": ingest_s,
        "ingest_rows": {"update_10000": burst.count, "update_pinned": 1,
                        "delete_100": tomb.count, "append_64": grow.count},
        "scatter_rows_launches": scatter_rows.launches,
        "scatter_rows_launches_update_10000": burst_launches,
        "scatter_rows_ms": scatter_ms,
        "compact_s": compact_s, "compacted_deltas": compacted,
        "last_swap_update": swap_after_update,
        "last_swap": pipe.backend.last_swap,
        "planner": dict(planner.metrics), "store": dict(live.metrics),
        "path_counts": dict(pipe.backend.path_counts),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
    })
    del pipe, live, planned
    torch.cuda.empty_cache()


def serve_multi(label, pir_ct, cfg, store_, dev, rng, kernel, family,
                flushes=2, breakdown=False, also=()):
    """8 multi-index requests per batch, k from 1 to 4 (a relying party
    fetching a certificate with its chain): one flat bucket of 8 x 4.
    ``kernel`` and each wrapper in ``also`` must launch d times a batch.
    With ``breakdown``, one more batch through the pipeline's entry points
    is cut into plan and execute; returns (label, pipe, planned) of that
    batch for ``per_server_split``, which waits until the path's counts are
    read."""
    pipe = pir_ct.make_serving_pipeline(cfg, store=store_, device=dev, seed=6)
    torch.cuda.reset_peak_memory_stats()
    times, launches = [], []
    counted = (kernel,) + tuple(also)

    def submit():
        ks = rng.integers(1, 5, size=8)
        ks[0] = 4  # the longest chain sets k_max = 4
        asked = {f"client-{c}": rng.integers(0, store_.n, size=int(k))
                 for c, k in enumerate(ks)}
        for client, lst in asked.items():
            if not pipe.submit_many(client, [int(i) for i in lst]):
                raise AssertionError("budget refused a request")
        return asked

    def check(out, asked, before, what):
        grew = [f_.launches - b for f_, b in zip(counted, before)]
        if any(g != cfg.d for g in grew):
            raise AssertionError(
                f"{label}: {[f_.__name__ for f_ in counted]} launched {grew} "
                f"times in {what}, expected d={cfg.d}")
        for client, lst in asked.items():
            want = np.stack([store_.record_bytes(int(i)) for i in lst])
            if out[client].shape != (len(lst), cfg.record_bytes) or \
                    not np.array_equal(out[client], want):
                raise AssertionError(f"{label}: wrong rows for {client}")
        return grew[0]

    for _ in range(flushes):
        asked = submit()
        before = [f_.launches for f_ in counted]
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = pipe.flush()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        launches.append(check(out, asked, before, "one batch"))
    if pipe.backend.path_counts[family] != cfg.d * flushes:
        raise AssertionError(f"{label}: {pipe.backend.path_counts}")
    plan = next(iter(pipe.backend.planner._plans.values()))
    line = {
        "phase": label, "scheme": cfg.scheme, "n": store_.n,
        "record_bytes": cfg.record_bytes, "d": cfg.d, "requests": 8,
        "flat_bucket": plan.bucket, "flushes": flushes, "flush_s": times,
        "kernel": kernel.__name__, "launches_per_batch": launches,
        "exec_plan": plan.describe(), "blocks": dict(plan.blocks),
        "path_counts": dict(pipe.backend.path_counts),
        "metrics": {k: pipe.metrics[k] for k in ("queries", "batches",
                                                 "padded")},
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
    }
    deferred = None
    if breakdown:
        asked = submit()
        before = [f_.launches for f_ in counted]
        cut = pipe.take_batch()
        torch.cuda.synchronize()
        t = time.perf_counter()
        planned = pipe.plan_requests(cut)
        torch.cuda.synchronize()
        plan_s = time.perf_counter() - t
        t = time.perf_counter()
        results = pipe.execute_planned(planned)
        torch.cuda.synchronize()
        execute_s = time.perf_counter() - t
        check({r.client: a for r, a in results}, asked, before,
              "the batch cut into phases")
        line["breakdown"] = {"plan_s": plan_s, "execute_s": execute_s}
        deferred = (label, pipe, planned)
    emit(line)
    del pipe
    torch.cuda.empty_cache()
    return deferred


def per_server_split(label, pipe, planned):
    """A planned batch's d per-server answers enqueued back to back with
    ONE synchronisation (against answer_batch's d), one server's answer,
    the index compaction inside it, and the reconstruction (CUDA events).
    Measurement only: it runs after the path's launch counts are read."""
    from repro_torch.kernels.gather_xor import indices_from_mask

    servers = range(len(planned.routed.servers))
    torch.cuda.synchronize()
    t = time.perf_counter()
    for pos in servers:
        planned.exec_plan(planned.routed.payload[pos])
    torch.cuda.synchronize()
    extra = {"phase": "breakdown", "of": label,
             "answers_one_sync_s": time.perf_counter() - t,
             "exec_plan": planned.exec_plan.describe()}
    masks0 = planned.routed.payload[0]
    m_budget = planned.exec_plan.m_budget
    extra["answer_ms_per_server"] = time_ms(
        lambda: planned.exec_plan(masks0), iters=5)
    if m_budget is not None:
        extra["indices_from_mask_ms"] = time_ms(
            lambda: indices_from_mask(masks0, m_budget), iters=5)
    stacked = torch.stack([
        planned.exec_plan(planned.routed.payload[pos]) for pos in servers])
    extra["reconstruct_ms"] = time_ms(
        lambda: pipe.router.finalize(planned.routed, stacked), iters=5)
    emit(extra)


def device_split(fn, groups):
    """Device time of one run of ``fn`` by kernel, from a torch.profiler
    trace of the card: milliseconds per group (a group takes the kernels
    whose name holds one of its substrings; "other" the rest), the summed
    kernel time, the host wall time and the busy share (kernel time over
    wall time). Measurement only: it runs ``fn`` once more."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    split = {g: 0.0 for g in list(groups) + ["other"]}
    launches = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.end - e.time_range.start
        launches += 1
        group = next((g for g, keys in groups.items()
                      if any(k in e.name for k in keys)), "other")
        split[group] += us / 1e3
    busy = sum(split.values())
    return {"ms": split, "device_ms": busy, "wall_ms": wall * 1e3,
            "busy_share": busy / (wall * 1e3) if wall > 0 else None,
            "device_events": launches}


def device_runs_ms(kernel_fn, library_fn, kernel_name, runs, calls=10):
    """The card's time of one call of a kernel and of the library call on
    the same operands, in ``runs`` turns of ``calls`` calls of each, all
    in one torch.profiler session (back to back, sessions can lose a
    run's events). The card's events, in order of start, fall into turns
    by whether they are the kernel's; if they do not make 2 x ``runs``
    turns, no time is given. Measurement only."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            for fn in (kernel_fn, library_fn):
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
    turns = []  # [is the kernel's, microseconds]
    for e in sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start):
        mine = kernel_name in e.name
        if not turns or turns[-1][0] != mine:
            turns.append([mine, 0.0])
        turns[-1][1] += e.time_range.end - e.time_range.start
    if len(turns) != 2 * runs:
        return {"kernel_device_ms_runs": None, "library_device_ms_runs": None,
                "device_turns_seen": len(turns)}
    return {key: [us / 1e3 / calls for mine, us in turns if mine == want]
            for key, want in (("kernel_device_ms_runs", True),
                              ("library_device_ms_runs", False))}


def fused_runs(forms, want, calls=10):
    """Each form of a fused kernel (a grid order through the wrapper, or a
    staging path forced through ``fused._launch``) held bit for bit against
    ``want`` and timed: CUDA events (2 warm-ups, mean of 50) and the card's
    own time of one call (torch.profiler over ``calls`` calls)."""
    runs = {}
    for name, fn in forms.items():
        err = max_abs_err(fn(), want)
        if err != 0:
            raise AssertionError(f"fused form {name} differs from the plain "
                                 f"answer (max abs err {err})")
        split = device_split(lambda: [fn() for _ in range(calls)],
                             {"fused": ["slab_kernel"]})
        runs[name] = {"ms": time_ms(fn, iters=50),
                      "device_ms": split["device_ms"] / calls,
                      "max_abs_err": err}
    return runs


def fused_forms(kernel, launch, schedule, stagings, db, idx, offsets,
                k_max, block_w, orders, budget):
    """The forms ``fused_runs`` times: each grid order through the wrapper
    (``kernel``), and each staging path each order can run, forced."""
    forms = {}
    for go in orders:
        if offsets is None:
            forms[go] = lambda go=go: kernel(db, idx, block_w=block_w,
                                             grid_order=go)
        else:
            forms[go] = lambda go=go: kernel(db, idx, offsets, k_max=k_max,
                                             block_w=block_w, grid_order=go)
        for st in stagings:
            try:
                sched = schedule(db.shape[0], db.shape[1], idx.shape[0],
                                 block_w, grid_order=go, k_max=k_max,
                                 budget=budget, staging=st)
            except ValueError:  # TMA where it cannot run
                continue
            forms[f"{go}/{st}"] = lambda s=sched: launch(db, idx, offsets,
                                                         k_max, s)
    return forms


def attention_pairs(sq: int, sk: int, causal: bool, window) -> int:
    """Unmasked (query, key) pairs of one attention row (positions from 0)."""
    qpos = np.arange(sq, dtype=np.int64)
    hi = np.minimum(qpos + 1, sk) if causal else np.full(sq, sk, np.int64)
    lo = (np.clip(qpos - window + 1, 0, sk) if window is not None
          else np.zeros(sq, np.int64))
    return int(np.maximum(hi - lo, 0).sum())


def flash_bound(bh, sq, sk, d, causal, window, dtype, peak=None, passes=1):
    """The larger of ``passes`` × 4·d flops per unmasked pair over ``peak``
    (by default the type's: bf16 tensor cores, float32 outside them) and
    the Q/K/V/O bytes over the memory rate."""
    elem = 2 if dtype == torch.bfloat16 else 4
    if peak is None:
        peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S
    ops_s = (passes * 4.0 * bh * attention_pairs(sq, sk, causal, window) * d
             / peak)
    bytes_s = bh * (2 * sq + 2 * sk) * d * elem / HBM_BYTES_PER_S
    return (max(ops_s, bytes_s) * 1e3,
            "operations" if ops_s > bytes_s else "bytes")


def bert4rec_fold_operands(dev):
    """The operands of one ``xor_fold`` launch of the private BERT4Rec path:
    the item table as a store of 64 words per record, and the request masks
    of server 0 that Sparse-PIR's query stage builds for the 6400 item ids
    of 32 users (the config's d, d_a and θ)."""
    from repro_torch.configs import get_arch
    from repro_torch.core.protocol import as_protocol
    from repro_torch.core.schemes import make_scheme
    from repro_torch.data import bert4rec_batch
    from repro_torch.db.store import RecordStore
    from repro_torch.models.recsys import bert4rec_vocab

    cfg = get_arch("bert4rec").CONFIG
    g = torch.Generator(device=dev).manual_seed(0)
    table = torch.randn((bert4rec_vocab(cfg), cfg.embed_dim), generator=g,
                        device=dev)
    store_ = RecordStore.from_float_table(table)
    staged = as_protocol(make_scheme(
        "sparse", cfg.private_lookup_d, cfg.private_lookup_da,
        theta=cfg.private_lookup_theta))
    ids = torch.from_numpy(bert4rec_batch(cfg, 32, seed=0, step=0)["seq"])
    ids = ids.reshape(-1).to(device=dev, dtype=torch.int32)
    gen = torch.Generator(device=dev).manual_seed(1)
    plan = staged.precompute(gen, store_.n, int(ids.numel()))
    mask = staged.query(plan, ids).payload[0].contiguous()
    del plan
    torch.cuda.empty_cache()
    return store_.packed, mask


def fold_bound(db, mask):
    """xor_fold's bound: the store, the mask and the answers moved once,
    against one 32-bit XOR per word of each selected row at the card's
    32-bit rate outside the tensor cores."""
    (n, w), q = db.shape, mask.shape[0]
    bytes_s = (n * w * 4 + mask.numel() * mask.element_size()
               + q * w * 4) / HBM_BYTES_PER_S
    ops_s = int(torch.count_nonzero(mask)) * w / F32_FLOPS_PER_S
    return (max(ops_s, bytes_s) * 1e3,
            "operations" if ops_s > bytes_s else "bytes")


def parity_bound(q, n, b, out_bytes):
    """parity_matmul's bound: 2·q·n·B operations at the int8 tensor-core
    peak, against the mask, the planes and the output moved once."""
    ops_s = 2.0 * q * n * b / INT8_OPS_PER_S
    bytes_s = (q * n + n * b + out_bytes) / HBM_BYTES_PER_S
    return (max(ops_s, bytes_s) * 1e3,
            "operations" if ops_s > bytes_s else "bytes")


def shuffled_ids(idx, rng):
    """The same ids in another order within each row, with duplicates (a
    pair of extra copies of some ids, which cancel) and -1 between them:
    index rows that are not ascending, which gather_xor walks per query."""
    q, m = idx.shape
    g = torch.Generator(device=idx.device).manual_seed(
        int(rng.integers(1 << 30)))
    perm = torch.argsort(torch.rand((q, m), generator=g, device=idx.device),
                         dim=1)
    out = torch.gather(idx, 1, perm)
    out[:, 5::97] = -1
    dup = out[:, 1::61].clone()
    out[:, 2::61][:, : dup.shape[1]] = dup[:, : out[:, 2::61].shape[1]]
    return out.contiguous()


def check_gather(db, q, theta, rng, dev, sweep):
    """gather_xor.cu at one batch of q Sparse-PIR masks over the CT store:
    on the ascending ids the compaction emits (the serving path's) and on
    the same ids shuffled with duplicates and -1 inside (the walk), each
    bit for bit against the plain version, timed beside the dense fold on
    the same masks; with ``sweep``, every grid order x block_w in {32, 128}
    timed and held bit-identical."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.gather_xor import (
        gather_xor, gather_xor_plain, indices_from_mask,
    )
    from repro_torch.kernels.xor_fold import xor_fold

    n, w = db.shape
    m = ops.sparse_index_budget(n, theta)
    smask = random_mask(rng, q, n, theta, dev)
    idx = indices_from_mask(smask, m)
    distinct = int(torch.unique(idx[idx >= 0]).numel())
    # the distinct live rows, the index rows and the answers, moved once
    bound = ((distinct * w * 4 + q * m * 4 + q * w * 4) / HBM_BYTES_PER_S
             * 1e3, "bytes")
    row = check_kernel(
        "gather_xor",
        {"n": n, "W": w, "q": q, "m": m, "ids": "ascending",
         "distinct_rows": distinct, "block_w": 128, "grid_order": "qwm"},
        lambda: gather_xor(db, idx), lambda: gather_xor_plain(db, idx),
        bound, "gather_xor.cu", "src/repro/kernels/gather_xor.py:97",
        plain_iters=1)
    # the index matrix is the compaction of the mask: the gather over it
    # must equal the dense fold of the same mask
    if max_abs_err(gather_xor(db, idx), xor_fold(db, smask)) != 0:
        raise AssertionError("gather_xor(indices_from_mask) != xor_fold")
    row["dense_fold_same_masks_ms"] = time_ms(lambda: xor_fold(db, smask))
    mess = shuffled_ids(idx, rng)
    err = max_abs_err(gather_xor(db, mess), gather_xor_plain(db, mess))
    if err != 0:
        raise AssertionError(f"gather_xor q={q} on shuffled ids differs from "
                             f"the plain version ({err})")
    row["shuffled"] = {"ids": "shuffled, duplicated, -1 inside",
                       "max_abs_err": err,
                       "ms": time_ms(lambda: gather_xor(db, mess))}
    if sweep:
        want = gather_xor(db, idx)
        row["schedules_ms"] = {}
        for go in ("qwm", "wqm"):
            for bw in (32, 128):
                if max_abs_err(gather_xor(db, idx, block_w=bw, grid_order=go),
                               want) != 0:
                    raise AssertionError(f"gather_xor {go}/{bw} differs")
                row["schedules_ms"][f"{go}/{bw}"] = time_ms(
                    lambda: gather_xor(db, idx, block_w=bw, grid_order=go))
        del want
    del smask, idx, mess
    torch.cuda.empty_cache()
    return row


def check_indices_from_mask(n, theta, rng, dev):
    """indices_from_mask.cu at the lookup path's masks ([8, n] uint8, m =
    the Sparse-PIR budget) and the multi path's ([32, n]), timed against
    the mask and id bytes; held bit for bit against the plain version
    there and on edge cases: a truncating m, an all-zero and an all-one
    row, n off the kernel's 8192-column tile, bool and int32 masks."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.gather_xor import (
        indices_from_mask, indices_from_mask_plain,
    )

    m = ops.sparse_index_budget(n, theta)

    def held(mask, m_):
        err = max_abs_err(indices_from_mask(mask, m_),
                          indices_from_mask_plain(mask, m_))
        if err != 0:
            raise AssertionError(f"indices_from_mask {tuple(mask.shape)} "
                                 f"{mask.dtype} m={m_}: kernel differs from "
                                 f"the plain version ({err})")
        return err

    rows = []
    for q in (8, 32):
        mask = random_mask(rng, q, n, theta, dev)
        rows.append(check_kernel(
            "indices_from_mask",
            {"q": q, "n": n, "m": m, "mask_dtype": "uint8", "theta": theta},
            lambda: indices_from_mask(mask, m),
            lambda: indices_from_mask_plain(mask, m),
            ((q * n + q * m * 4) / HBM_BYTES_PER_S * 1e3, "bytes"),
            "indices_from_mask.cu",
            "src/repro/kernels/gather_xor.py:107 (no TPU kernel: jnp.argsort)",
            plain_iters=2))
        del mask
    edge = random_mask(rng, 6, n - 3, theta, dev)  # n - 3: off the tile
    edge[0] = 0
    edge[-1] = 1
    edge[2, ::5] *= 2
    cases = {"truncating_m": held(edge, m // 4), "budget_m": held(edge, m),
             "m_eq_n": held(edge, n - 3), "bool": held(edge.bool(), m // 4),
             "int32": held(edge.to(torch.int32), m)}
    rows[0]["at_q32"] = {k: rows[1][k] for k in (
        "shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}
    rows[0]["edge_cases"] = {"n": n - 3, "rows": "all zero, all one, "
                             "values 2", "max_abs_err": cases}
    del edge
    torch.cuda.empty_cache()
    return rows[0]


def check_parity(pmask, planes, planes_rows, extra, iters, plain_iters,
                 fp32_library):
    """parity_matmul.cu's two forms on one operand set, each against its
    plain version (tolerance 0), with the planes in the serving path's
    layout (``planes``: the [n, B] view of a [B, n] tensor) and in the
    reference's (``planes_rows``: [n, B], which the kernel transposes on
    the way), timed beside the plain version and two PyTorch products that
    the port never calls: ``torch.matmul`` in fp32 (exact here) and
    ``torch._int_mm`` (cuBLAS int8 -> int32), both without the mod 2. The
    row's ``ms`` is the packed form on the path's layout."""
    from repro_torch.db import packing
    from repro_torch.kernels.parity_matmul import (
        parity_matmul, parity_matmul_packed, parity_matmul_packed_plain,
        parity_matmul_plain,
    )

    (q, n), b = pmask.shape, planes.shape[1]
    words = -(-b // 32)
    want = parity_matmul_plain(pmask, planes_rows)
    want_words = packing.pack_bits(want)
    errs = {}
    for layout, pl in (("n_contiguous", planes), ("rows", planes_rows)):
        errs[layout] = {
            "uint8": max_abs_err(parity_matmul(pmask, pl), want),
            "packed": max_abs_err(parity_matmul_packed(pmask, pl),
                                  want_words)}
    torch.cuda.synchronize()
    del want, want_words
    if any(e for v in errs.values() for e in v.values()):
        raise AssertionError(f"parity_matmul q={q} n={n} B={b}: kernel "
                             f"differs from the plain version: {errs}")
    library_ms, library = None, "torch.matmul fp32: not timed, the fp32 " \
        "planes would not fit beside the uint8 ones"
    if fp32_library:
        a32, b32 = pmask.float(), planes_rows.float()
        library_ms = time_ms(lambda: torch.matmul(a32, b32), iters=3)
        library = "torch.matmul fp32"
        del a32, b32
        torch.cuda.empty_cache()
    a8, b8 = pmask.view(torch.int8), planes.view(torch.int8)
    try:
        int8_ms, int8_note = time_ms(lambda: torch._int_mm(a8, b8),
                                     iters=3), "torch._int_mm"
    except RuntimeError as e:  # a yardstick PyTorch may refuse: say why
        int8_ms, int8_note = None, str(e).splitlines()[0]
    bound_ms, bound_by = parity_bound(q, n, b, q * words * 4)
    u8_bound_ms, u8_bound_by = parity_bound(q, n, b, q * b)
    # the card's own time for one call (torch.profiler): the kernel, and
    # the output's zeroing where the shape splits n
    calls = 10
    split = device_split(
        lambda: [parity_matmul_packed(pmask, planes) for _ in range(calls)],
        {"kernel": ["parity_kernel"], "memset": ["emset"]})
    return {
        "name": "parity_matmul", "counter": "parity_matmul_packed",
        "route": "cuda", "source": CSRC + "parity_matmul.cu",
        "replaces": "src/repro/kernels/parity_matmul.py:93",
        "shape": {"q": q, "n": n, "B": b, "output": "packed words",
                  "planes": "n_contiguous", **extra},
        "launches": 0, "max_abs_err": 0, "errors": errs, "tolerance": 0,
        "ms": time_ms(lambda: parity_matmul_packed(pmask, planes),
                      iters=iters),
        "device_ms": {k: split["ms"][k] / calls for k in ("kernel",
                                                          "memset")},
        "plain_ms": time_ms(
            lambda: parity_matmul_packed_plain(pmask, planes), warmup=1,
            iters=plain_iters),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms, "library": library,
        "library_ms_int8": int8_ms, "library_int8": int8_note,
        "uint8_form": {
            "ms": time_ms(lambda: parity_matmul(pmask, planes), iters=iters),
            "bound_ms": u8_bound_ms, "bound_by": u8_bound_by},
        # the reference's [n, B] layout: the kernel transposes each tile
        "rows_layout": {
            "ms": time_ms(lambda: parity_matmul_packed(pmask, planes_rows),
                          iters=iters),
            "uint8_ms": time_ms(lambda: parity_matmul(pmask, planes_rows),
                                iters=iters)},
    }


def tensor_core_sass(lib_path, name):
    """Tensor-core instructions in the SASS of the built library's kernels
    whose name holds ``name`` (``cuobjdump -sass``): {kernel: {mnemonic:
    count}}, e.g. IGMMA for an integer wgmma."""
    from repro_torch.kernels import _build

    tool = Path(_build._find_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    found, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if name in m.group(1) else None
            if fn:
                found[fn] = {}
            continue
        m = re.search(r"\b([IH]GMMA|[IH]MMA)\b", line)
        if fn and m:
            found[fn][m.group(1)] = found[fn].get(m.group(1), 0) + 1
    return found


def crossover(db, planes, buckets, rng, dev, configured):
    """The fold against the parity path (the packed kernel, the planes as
    the planner holds them) on the same random masks at each scheduler
    bucket; the measured crossover is the smallest bucket at which parity
    was faster. The parity path on the reference's [n, B] planes, which the
    kernel transposes on the way, rides along."""
    from repro_torch.kernels import ops

    planes_rows = planes.contiguous()
    cross = []
    for bucket in buckets:
        bm = random_mask(rng, bucket, db.shape[0], 0.5, dev)
        it = 5 if bucket <= 128 else 2
        cross.append({
            "bucket": bucket,
            "fold_ms": time_ms(lambda: ops.server_answer_fold(db, bm),
                               warmup=1, iters=it),
            "parity_ms": time_ms(
                lambda: ops.server_answer_parity(planes, bm), warmup=1,
                iters=it),
            "parity_rows_layout_ms": time_ms(
                lambda: ops.server_answer_parity(planes_rows, bm),
                warmup=1, iters=it),
        })
        del bm
    del planes_rows
    wins = [c["bucket"] for c in cross if c["parity_ms"] < c["fold_ms"]]
    return {"n": db.shape[0], "B": planes.shape[1], "buckets": cross,
            "measured_crossover": min(wins) if wins else None,
            "configured_crossover": configured}


def serve_chor_ct_b128(pir_ct, cfg, store, dev, rng, wrappers,
                       ShardedBackend, never, read_counts, reset_counts):
    """CT-scale Chor (n = 10^6 x 1536 B, d = 100) in buckets of 128: two
    flushes with the planner's own unforced fold/parity choice, then two
    flushes of the same traffic forced to the other path (parity_min_batch
    =128 if it chose the fold, ``never`` if it chose parity), so that each
    path is driven once. Every record is checked. Returns the launch counts
    of the unforced and forced-parity runs (a forced-fold run and the
    per-server timings come after they are read)."""
    chor = dataclasses.replace(cfg, scheme="chor", query_batch=128)
    batch = 128

    def run(label, flushes, parity_min_batch):
        kw = {}
        if parity_min_batch is not None:
            kw["backend"] = ShardedBackend(
                store, backend=chor.backend,
                parity_min_batch=parity_min_batch, device=dev)
        pipe = pir_ct.make_serving_pipeline(chor, store=store, device=dev,
                                            seed=8, **kw)
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        before = {k: w.launches for k, w in wrappers.items()}
        forms_before = dict(wrappers["xor_fold"].kernel_launches)
        times = []
        for _ in range(flushes):
            picks = rng.integers(0, store.n, size=batch)
            for c, i in enumerate(picks):
                if not pipe.submit(f"client-{c}", int(i)):
                    raise AssertionError("budget refused a query")
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = pipe.flush()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            for c, i in enumerate(picks):
                if not np.array_equal(out[f"client-{c}"],
                                      store.record_bytes(int(i))):
                    raise AssertionError(f"serve_chor_ct_b128 {label}: "
                                         f"wrong record {int(i)}")
        (plan,) = pipe.backend.planner._plans.values()
        counts = dict(pipe.backend.path_counts)
        if counts[plan.path] != cfg.d * flushes:
            raise AssertionError(f"serve_chor_ct_b128 {label}: {counts}")
        forms_ran = {f: c - forms_before[f] for f, c in
                     wrappers["xor_fold"].kernel_launches.items()}
        # a fold at bucket 128 takes the table form, every answer
        if plan.path == "fold" and forms_ran["table"] != cfg.d * flushes:
            raise AssertionError(f"serve_chor_ct_b128 {label}: xor_fold "
                                 f"forms {forms_ran}")
        return pipe, {
            "run": label, "parity_min_batch": parity_min_batch,
            "path": plan.path, "exec_plan": plan.describe(),
            "path_counts": counts, "flushes": flushes, "flush_s": times,
            "lookups_per_s": batch / times[-1],
            "launches": {k: w.launches - before[k]
                         for k, w in wrappers.items()
                         if w.launches != before[k]},
            "xor_fold_form_launches": forms_ran,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "memory_allocated_before": resident,
        }

    def answer_ms(pipe, line):
        # one server's answer to one planned batch (CUDA events)
        for c, i in enumerate(rng.integers(0, store.n, size=batch)):
            pipe.submit(f"client-{c}", int(i))
        planned = pipe.plan_requests(pipe.take_batch())
        mask0 = planned.routed.payload[0]
        line["answer_ms_per_server"] = time_ms(
            lambda: planned.exec_plan(mask0), iters=5)

    reset_counts()
    pipes, runs = [], []
    pipe, line = run("unforced", 2, None)
    pipes.append(pipe)
    runs.append(line)
    if line["path"] != "parity":
        pipe, line = run("forced_parity", 2, batch)
        pipes.append(pipe)
        runs.append(line)
    counts = read_counts()
    if counts["parity_matmul_packed"] != 2 * cfg.d:
        raise AssertionError(f"serve_chor_ct_b128: {counts}")
    for pipe, line in zip(pipes, runs):
        answer_ms(pipe, line)
    # a pipeline's planner and its plans refer to each other: free the
    # 12.29 GB of planes now, not at the collector's leisure
    del pipes, pipe
    gc.collect()
    torch.cuda.empty_cache()
    if runs[0]["path"] == "parity":
        pipe, line = run("forced_fold", 2, never)
        answer_ms(pipe, line)
        runs.append(line)
        del pipe
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "serve_chor_ct_b128", "scheme": "chor", "n": store.n,
          "record_bytes": cfg.record_bytes, "d": cfg.d, "batch": batch,
          "planner_choice": runs[0]["path"],
          "forced_parity_too": runs[0]["path"] != "parity",
          "forced_fold_too": runs[0]["path"] == "parity", "runs": runs,
          "parity_launches": counts["parity_matmul_packed"]})
    return counts


def serve_scheme(label, pir_ct, cfg, store, dev, rng, wrappers, expect,
                 path, servers_per_batch, flushes=2, batch=8):
    """One of the paper's other schemes on the CT store through the
    config's pipeline: ``flushes`` flushes of ``batch`` lookups, every
    record checked, each wrapper in ``expect`` launched exactly
    ``expect[name]`` times a batch (and no other answer kernel), the
    backend's ``path`` counted ``servers_per_batch`` times a batch. The
    replicas each flush contacted ride along (Subset-PIR takes the
    pipeline's latency-EMA ranking)."""
    pipe = pir_ct.make_serving_pipeline(cfg, store=store, device=dev, seed=3)
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    at_start = {k: f_.launches for k, f_ in wrappers.items()}
    times, contacted = [], []
    for f in range(flushes):
        seen = {s: st.n for s, st in pipe.backend.stats.items()}
        before = {k: f_.launches for k, f_ in wrappers.items()}
        picks = rng.integers(0, store.n, size=batch)
        for c, i in enumerate(picks):
            if not pipe.submit(f"client-{c}", int(i)):
                raise AssertionError(f"{label}: budget refused a query")
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = pipe.flush()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        for c, i in enumerate(picks):
            if not np.array_equal(out[f"client-{c}"],
                                  store.record_bytes(int(i))):
                raise AssertionError(f"{label}: wrong record {int(i)}")
        grew = {k: f_.launches - before[k] for k, f_ in wrappers.items()}
        want = {k: expect.get(k, 0) for k in grew}
        if grew != want:
            raise AssertionError(f"{label}: launches {grew}, want {want}")
        contacted.append(sorted(s for s, st in pipe.backend.stats.items()
                                if st.n > seen.get(s, 0)))
        if len(contacted[-1]) != servers_per_batch:
            raise AssertionError(f"{label}: contacted {contacted[-1]}")
    if pipe.backend.path_counts[path] != servers_per_batch * flushes:
        raise AssertionError(f"{label}: {pipe.backend.path_counts}")
    eps, delta = pipe.price
    spent = pipe.budget("client-0").spent_epsilon
    if spent != flushes * eps:
        raise AssertionError(f"{label}: client-0 spent {spent}, not "
                             f"{flushes} x {eps}")
    line = {
        "phase": label, "scheme": cfg.scheme, "n": store.n,
        "record_bytes": cfg.record_bytes, "d": cfg.d, "d_a": cfg.d_a,
        "signature": list(pipe.staged.signature),
        "batch": batch, "flushes": flushes, "flush_s": times,
        "lookups_per_s": batch / times[-1], "exact": True,
        "epsilon_per_query": eps, "delta_per_query": delta,
        "path_counts": dict(pipe.backend.path_counts),
        "contacted": contacted,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "memory_allocated_before": resident,
        "launches_this_phase": {
            k: f_.launches - at_start[k] for k, f_ in wrappers.items()
            if f_.launches != at_start[k]},
    }
    emit(line)
    del pipe
    torch.cuda.empty_cache()
    return line


def serve_cached(pir_ct, cfg, store, dev, rng, wrappers):
    """The cross-batch cache on the CT store (Sparse-PIR, batch 8, the
    config's ``cache_entries``): a batch of misses; the same (client,
    index) pairs again, answered from the memo with no kernel launch and
    the budget spent all the same; a pre banked by ``prefill_cache`` and
    consumed by a batch of new misses."""
    label = "serve_cached_sparse_ct"
    pipe = pir_ct.make_serving_pipeline(cfg, store=store, device=dev, seed=3)
    cache = pipe.cache
    if cache is None or cache.max_entries != cfg.cache_entries:
        raise AssertionError(f"{label}: the config attached no cache")
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    eps = pipe.price[0]
    batch = 8

    def flush(picks, what, expect_kernels):
        before = {k: f_.launches for k, f_ in wrappers.items()}
        for c, i in enumerate(picks):
            if not pipe.submit(f"client-{c}", int(i)):
                raise AssertionError(f"{label}: budget refused a query")
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = pipe.flush()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        for c, i in enumerate(picks):
            if not np.array_equal(out[f"client-{c}"],
                                  store.record_bytes(int(i))):
                raise AssertionError(f"{label}: wrong record {int(i)}")
        grew = {k: f_.launches - before[k] for k, f_ in wrappers.items()
                if f_.launches != before[k]}
        if bool(grew) != expect_kernels:
            raise AssertionError(f"{label} ({what}): launches {grew}")
        return dt, grew

    picks = rng.integers(0, store.n, size=batch)
    miss_s, miss_launches = flush(picks, "misses", True)
    hit_s, hit_launches = flush(picks, "hits", False)
    if pipe.metrics["cache_hits"] != batch:
        raise AssertionError(f"{label}: {pipe.metrics['cache_hits']} hits")
    if pipe.budget("client-0").spent_epsilon != 2 * eps:
        raise AssertionError(f"{label}: a hit did not spend its epsilon")
    torch.cuda.synchronize()
    t = time.perf_counter()
    banked = pipe.prefill_cache(batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    if banked != 1 or cache.pre_depth(batch) != 1:
        raise AssertionError(f"{label}: prefill banked {banked}")
    pre_bytes = cache.pre_bytes
    peak_with_pre = torch.cuda.max_memory_allocated()
    fresh = rng.integers(0, store.n, size=batch)
    pre_s, pre_launches = flush(fresh, "misses on the banked pre", True)
    if cache.metrics["pre_used"] != 1 or cache.pre_depth(batch) != 0:
        raise AssertionError(f"{label}: the pre was not consumed")
    line = {
        "phase": label, "scheme": cfg.scheme, "n": store.n,
        "record_bytes": cfg.record_bytes, "d": cfg.d, "batch": batch,
        "cache_entries": cache.max_entries,
        "flush_s": {"misses": miss_s, "hits": hit_s,
                    "misses_on_pre": pre_s},
        "lookups_per_s": {"misses": batch / miss_s, "hits": batch / hit_s,
                          "misses_on_pre": batch / pre_s},
        "prefill_s": prefill_s, "pre_bytes": pre_bytes,
        "launches": {"misses": miss_launches, "hits": hit_launches,
                     "misses_on_pre": pre_launches},
        "epsilon_per_query": eps,
        "epsilon_spent_client_0": pipe.budget("client-0").spent_epsilon,
        "cache_metrics": dict(cache.metrics),
        "pipeline_cache_hits": pipe.metrics["cache_hits"],
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "max_memory_allocated_with_pre": peak_with_pre,
        "memory_allocated_before": resident,
    }
    emit(line)
    del pipe, cache
    torch.cuda.empty_cache()
    return line


def autotune_ct(pir_ct, cfg, store, dev, rng, smi):
    """The measured planner on the CT store: the sparse cell at bucket 8
    planned by a flush of the config's pipeline and tuned by its idle-time
    hook (``autotune_step``), the Chor cell at bucket 128 planned by the
    planner and tuned by ``tune_pending``; each candidate's µs, the prior's
    choice and the winner; each winner's answer against the plain fold,
    bit for bit; every raced candidate a kernel, the winner the fastest,
    and no slower than the plain versions, timed the same way outside the
    race; the table saved, reloaded, and a table in the JAX package's
    fingerprint (``{"platform": "gpu", ...}``) dropped."""
    import types

    from repro_torch._device import device_fingerprint
    from repro_torch.kernels.backend import (
        AutotuneTable,
        PlanCandidate,
        _measure_us,
        _path_answer_fn,
    )
    from repro_torch.kernels.xor_fold import xor_fold_plain
    from repro_torch.serve import ShardedBackend

    table = AutotuneTable(dev)
    backend = ShardedBackend(store, autotune=table, device=dev)
    pipe = pir_ct.make_serving_pipeline(cfg, store=store, device=dev,
                                        seed=3, backend=backend)
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    cells, tuned_cells = [], []

    def flush(what):
        picks = rng.integers(0, store.n, size=8)
        for c, i in enumerate(picks):
            if not pipe.submit(f"{what}-{c}", int(i)):
                raise AssertionError("autotune_ct: budget refused a query")
        out = pipe.flush()
        for c, i in enumerate(picks):
            if not np.array_equal(out[f"{what}-{c}"],
                                  store.record_bytes(int(i))):
                raise AssertionError(f"autotune_ct: wrong record {int(i)}")
        (plan,) = backend.planner._plans.values()
        return plan

    def record(name, bucket, theta, prior, tune):
        key = backend.planner._table_key(name, bucket, "cuda", theta)
        if backend.planner.pending() != (key,):
            raise AssertionError(f"autotune_ct: pending "
                                 f"{backend.planner.pending()}")
        tuned_cells.append((key, backend.planner._pending[key]))
        torch.cuda.synchronize()
        t = time.perf_counter()
        tuned = tune()
        torch.cuda.synchronize()
        tune_s = time.perf_counter() - t
        entry = table.get(key)
        if tuned != 1 or entry is None or entry["source"] != "measured":
            raise AssertionError(f"autotune_ct: {name} b{bucket} not tuned")
        us = entry["us"]
        if not all(k.split("+")[0].endswith("/cuda") for k in us):
            raise AssertionError(f"autotune_ct: not a kernel: {list(us)}")
        winner = PlanCandidate(entry["path"], entry["impl"],
                               tuple(sorted(entry["blocks"].items())))
        if entry["impl"] != "cuda" or min(us, key=us.get) != winner.label:
            raise AssertionError(f"autotune_ct: {winner.label} is not the "
                                 f"fastest of {us}")
        return key, {
            "cell": f"{name} b{bucket}", "key": list(key),
            "prior": prior.describe(), "prior_blocks": dict(prior.blocks),
            "winner": f"{entry['path']}/{entry['impl']}",
            "winner_blocks": entry["blocks"], "us": entry["us"],
            "tune_s": tune_s, "device": entry["device"],
        }

    # the sparse cell: a flush plans it from the prior, the idle hook
    # measures it, the next flush runs the winner
    sch = pipe.staged
    prior = flush("prior")
    if prior.source != "model":
        raise AssertionError(f"autotune_ct: {prior.describe()}")
    key, row = record("sparse", 8, cfg.theta, prior,
                      lambda: pipe.autotune_step())
    measured = flush("measured")
    if measured.source != "measured":
        raise AssertionError(f"autotune_ct: {measured.describe()}")
    mask = random_mask(rng, 8, store.n, cfg.theta, dev)
    row["max_abs_err_vs_plain_fold"] = max_abs_err(
        measured(mask), xor_fold_plain(store.packed, mask))
    cells.append(row)
    # the Chor cell at bucket 128
    chor = pir_ct.scheme_from_config(dataclasses.replace(cfg, scheme="chor"))
    wire = types.SimpleNamespace(kind="mask", theta=None)
    prior = backend.planner.plan(wire, 128, scheme=chor.staged)
    key, row = record("chor", 128, None, prior, backend.tune_pending)
    measured = backend.planner.plan(wire, 128, scheme=chor.staged)
    mask = random_mask(rng, 128, store.n, 0.5, dev)
    row["max_abs_err_vs_plain_fold"] = max_abs_err(
        measured(mask), xor_fold_plain(store.packed, mask))
    cells.append(row)
    if any(c["max_abs_err_vs_plain_fold"] != 0 for c in cells):
        raise AssertionError(f"autotune_ct: a winner differs: {cells}")
    peak = torch.cuda.max_memory_allocated()

    # the plain versions are no candidates; timed here on the same payload
    # in the same way, the measured winner must not lose to them
    planner = backend.planner
    for row, (key, cell) in zip(cells, tuned_cells):
        payload = planner._bench_payload(key, cell)
        plain = {}
        for c in planner._candidates(dataclasses.replace(cell, impl="ref")):
            fn = planner._build_run(c.path, _path_answer_fn(
                c.path, c.impl, cell.m_budget, dict(c.blocks)))
            plain[c.label] = _measure_us(fn, payload, candidate=c)
        del payload
        row["plain_us"] = plain
        if min(row["us"].values()) > min(plain.values()):
            raise AssertionError(f"autotune_ct: the winner lost to the "
                                 f"plain version: {row}")
    # save, reload (same device, same shape: everything kept), and a table
    # fingerprinted as the JAX package fingerprints this card: dropped
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    path = str(out_dir / "autotune_ct.json")
    backend.save_autotune(path)
    again = ShardedBackend(store, autotune=AutotuneTable(dev),
                           autotune_file=path, device=dev)
    kept = {k: v for k, v in again.planner.table.items()}
    if again.autotune_dropped != 0 or kept != dict(table.items()):
        raise AssertionError("autotune_ct: the reload changed the table")
    foreign = AutotuneTable(dev)
    for k, v in table.items():
        foreign.put(k, v["path"], impl=v["impl"], source=v["source"],
                    blocks=v["blocks"], us=v["us"],
                    device={"platform": "gpu",
                            "device_kind": torch.cuda.get_device_name(0)},
                    store_shape=v["store_shape"])
    foreign_path = str(out_dir / "autotune_ct_foreign.json")
    foreign.dump(foreign_path)
    other = ShardedBackend(store, autotune=AutotuneTable(dev),
                           autotune_file=foreign_path, device=dev)
    if other.autotune_dropped != len(table) or len(other.planner.table):
        raise AssertionError("autotune_ct: a foreign table was merged")
    line = {"phase": "autotune_ct", "card": smi, "n": store.n,
            "record_bytes": cfg.record_bytes, "d": cfg.d, "cells": cells,
            "entries": len(table), "reloaded": len(kept),
            "foreign_dropped": other.autotune_dropped,
            "fingerprint": device_fingerprint(dev),
            "max_memory_allocated": peak,
            "memory_allocated_before": resident}
    emit(line)
    del pipe, backend, again, other, measured, prior
    gc.collect()
    torch.cuda.empty_cache()
    return line


def _union(intervals):
    """Sorted, merged [start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _measure(intervals) -> float:
    return sum(e - s for s, e in intervals)


def _intersect(a, b) -> float:
    """Length of the intersection of two merged interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def stream_overlap(fn, groups):
    """One run of ``fn`` under torch.profiler, split by CUDA stream: each
    stream's device time by group (a group takes the events whose name
    holds one of its substrings; "other" the rest), the busy share (the
    union of every device interval over the host wall time), the time two
    or more streams ran at once, and, for each pair of groups, the time a
    group's events ran beside the other's. Measurement only."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    by_stream, by_group = {}, {g: [] for g in list(groups) + ["other"]}
    # the raw trace, not prof.events(): the kernels of this run are
    # launched from the front's threads, not from this one, and the raw
    # events carry each one's stream
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        start = e.start_ns() / 1e3
        iv = (start, start + e.duration_ns() / 1e3)
        name = e.name()
        group = next((g for g, keys in groups.items()
                      if any(k in name for k in keys)), "other")
        by_group[group].append(iv)
        stream = str(e.device_resource_id())
        by_stream.setdefault(stream, {g: [] for g in by_group})[group].append(
            iv)
    merged = {s: _union([iv for ivs in gs.values() for iv in ivs])
              for s, gs in by_stream.items()}
    busy = _union([iv for ivs in merged.values() for iv in ivs])
    # time with two or more streams active: sum of each stream's busy time
    # less the union's
    concurrent = sum(_measure(m) for m in merged.values()) - _measure(busy)
    groups_merged = {g: _union(ivs) for g, ivs in by_group.items()}
    names = sorted(groups_merged)
    return {
        "wall_ms": wall_us / 1e3,
        "device_busy_ms": _measure(busy) / 1e3,
        "busy_share": _measure(busy) / wall_us if wall_us > 0 else None,
        "streams": {s: {g: _measure(_union(ivs)) / 1e3
                        for g, ivs in gs.items() if ivs}
                    for s, gs in by_stream.items()},
        "two_streams_at_once_ms": concurrent / 1e3,
        "group_overlap_ms": {
            f"{a}|{b}": _intersect(groups_merged[a], groups_merged[b]) / 1e3
            for i, a in enumerate(names) for b in names[i + 1:]
            if groups_merged[a] and groups_merged[b]},
    }


SPARSE_GROUPS = {"sort": ["sort", "Sort"], "rand": ["uniform", "random",
                                                    "Random", "philox"],
                 "indices_from_mask": ["ifm_"],
                 "gather_xor": ["gather_xor_kernel", "gather_prep"],
                 "copy": ["Memcpy", "memcpy", "Memset", "memset"]}


def _submit_from_threads(fe, picks, submitters, prefix):
    """Submit ``picks`` from ``submitters`` threads, each its own share in
    order; returns the futures in the order of ``picks``."""
    import threading

    futs = [None] * len(picks)

    def feed(s):
        for j in range(s, len(picks), submitters):
            futs[j] = fe.submit(f"{prefix}{s}-{j % 64}", int(picks[j]))

    threads = [threading.Thread(target=feed, args=(s,))
               for s in range(submitters)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600.0)
    if any(t.is_alive() for t in threads):
        raise AssertionError("a submitter thread did not finish")
    return futs


def _check_futures(label, futs, picks, store_):
    for f, i in zip(futs, picks):
        if not np.array_equal(f.result(timeout=60.0),
                              store_.record_bytes(int(i))):
            raise AssertionError(f"{label}: wrong record for index {int(i)}")


def serve_async(label, pir_ct, cfg, store_, rng, wrappers, expect,
                lookups, read_counts, reset_counts, submitters=4,
                double_buffer=True, trace=False):
    """``lookups`` lookups from ``submitters`` threads through
    ``make_async_frontend`` on the card (no cache, so no banked plans),
    double-buffered or not; every future held against its record, and each
    kernel of ``expect`` launched ``expect[k]`` times a batch. The pipeline
    is warmed up first through its own entry points (one flush), and the
    front's idle-slot autotune is off, so that its batches plan from the
    prior as the synchronous phases' do. The counts are set to 0 after
    that warm-up, so that they hold the front's batches only. With
    ``trace``, a few more batches run under torch.profiler after the
    counts are read (measurement only). Returns the phase's line and
    ``read_counts()`` taken at the end of the run, before any traced
    batch."""
    fe = pir_ct.make_async_frontend(cfg, store=store_, seed=6)
    fe.double_buffer = double_buffer
    fe.autotune = False
    pipe = fe.pipeline
    for c, i in enumerate(rng.integers(0, store_.n, size=cfg.query_batch)):
        pipe.submit(f"warm-{c}", int(i))
    pipe.flush()
    reset_counts()
    picks = rng.integers(0, store_.n, size=lookups)
    batches0 = pipe.metrics["batches"]
    before = {k: f_.launches for k, f_ in wrappers.items()}
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with fe:
        t = time.perf_counter()
        futs = _submit_from_threads(fe, picks, submitters, "s")
        if not fe.drain(timeout=600.0):
            raise AssertionError(f"{label}: the front did not drain")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated()
        launches = {k: f_.launches - before[k] for k, f_ in wrappers.items()
                    if f_.launches != before[k]}
        batches = pipe.metrics["batches"] - batches0
        _check_futures(label, futs, picks, store_)
        m = fe.metrics
        if m["failed"] or m["served"] != lookups:
            raise AssertionError(f"{label}: {m}")
        for k, per in expect.items():
            if launches.get(k, 0) != per * batches:
                raise AssertionError(
                    f"{label}: {k} launched {launches.get(k, 0)} times in "
                    f"{batches} batches, expected {per} a batch")
        line = {
            "phase": label, "scheme": cfg.scheme, "n": store_.n,
            "record_bytes": cfg.record_bytes, "d": cfg.d,
            "bucket": cfg.query_batch, "submitters": submitters,
            "double_buffer": double_buffer, "lookups": lookups,
            "batches": batches, "wall_s": wall,
            "flushes_per_s": batches / wall, "lookups_per_s": lookups / wall,
            "launches": launches,
            "launches_a_batch": {k: v / batches for k, v in launches.items()},
            "memory_resident_at_start": resident,
            "max_memory_allocated": peak,
            "side_stream": None if fe._side is None else str(fe._side),
            "frontend": {k: m[k] for k in ("accepted", "served", "failed",
                                           "shed", "autotuned",
                                           "prefilled")},
        }
        counts = read_counts()
        if trace:
            more = rng.integers(0, store_.n, size=4 * cfg.query_batch)

            def traced():
                f2 = _submit_from_threads(fe, more, submitters, "t")
                if not fe.drain(timeout=600.0):
                    raise AssertionError(f"{label}: the front did not drain")
                _check_futures(label, f2, more, store_)

            line["trace"] = stream_overlap(traced, SPARSE_GROUPS)
    return line, counts


def serve_async_reduced(pir_ct, red, small, rng, wrappers):
    """The front on the reduced store: single lookups (the fused gather)
    then multi-index requests (the fused multi gather), each against its
    records."""
    fe = pir_ct.make_async_frontend(red, store=small, seed=8)
    pipe = fe.pipeline
    with fe:
        picks = rng.integers(0, small.n, size=64)
        futs = [fe.submit(f"r{j % 16}", int(i)) for j, i in enumerate(picks)]
        if not fe.drain(timeout=300.0):
            raise AssertionError("serve_async_reduced: no drain")
        _check_futures("serve_async_reduced", futs, picks, small)
        lists = [list(rng.integers(0, small.n, size=k)) for k in (1, 4, 2, 3)]
        many = [fe.submit_many(f"m{j}", lst) for j, lst in enumerate(lists)]
        if not fe.drain(timeout=300.0):
            raise AssertionError("serve_async_reduced: no drain")
        for f, lst in zip(many, lists):
            want = np.stack([small.record_bytes(int(i)) for i in lst])
            if not np.array_equal(f.result(timeout=60.0), want):
                raise AssertionError("serve_async_reduced: wrong records")
        m = fe.metrics
    emit({"phase": "serve_async_reduced", "n": small.n, "d": red.d,
          "served": m["served"], "failed": m["failed"],
          "batches": pipe.metrics["batches"],
          "path_counts": dict(pipe.backend.path_counts),
          "launches": {k: f_.launches for k, f_ in wrappers.items()
                       if f_.launches}})


def serve_async_live(pir_ct, cfg, base, rng, pir_delta_batch, VersionedStore,
                     scatter_rows):
    """The front over a live CT store: deltas through ``frontend.ingest``
    (the 10 000-row update burst, then an append of 64) beside lookups of
    the updated rows, which answer each the snapshot its batch pinned; one
    idle-slot compaction (the log is then 2 deep); then the appended and
    updated records served exactly from the head."""
    n, rb = base.n, cfg.record_bytes
    live = VersionedStore(base, shards=8)
    fe = pir_ct.make_async_frontend(cfg, store=live, seed=7)
    fe.compact_log_depth = 2
    pipe = fe.pipeline
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (burst,) = pir_delta_batch(n, rb, updates=10_000, seed=3, step=0)
    (grow,) = pir_delta_batch(n, rb, appends=64, seed=3, step=1)
    updated = [int(i) for i in burst.indices[:16]]
    old = {i: base.record_bytes(i) for i in updated}
    scatter0 = scatter_rows.launches
    with fe:
        warm = rng.integers(0, n, size=8)
        futs = [fe.submit(f"w{c}", int(i)) for c, i in enumerate(warm)]
        if not fe.drain(timeout=300.0):
            raise AssertionError("serve_async_live_ct: no drain")
        _check_futures("serve_async_live_ct", futs, warm, base)
        t = time.perf_counter()
        queued = 0
        for delta in (burst, grow):
            fe.ingest(delta)
            queued += 1
        racing = [fe.submit(f"u{c}", i) for c, i in enumerate(updated)]
        if not fe.drain(timeout=300.0):
            raise AssertionError("serve_async_live_ct: no drain")
        ingest_s = time.perf_counter() - t
        m = fe.metrics
        if m["ingested"] != queued or pipe.pending_deltas:
            raise AssertionError(
                f"serve_async_live_ct: {m['ingested']} deltas counted after "
                f"drain(), {queued} queued")
        head = live.snapshot()
        new = {i: head.record_bytes(i) for i in updated}
        if sum(not np.array_equal(old[i], new[i]) for i in updated) == 0:
            raise AssertionError("the update burst changed none of its rows")
        # each lookup answers the version its batch pinned: before or
        # after the burst, never a torn mix
        for f, i in zip(racing, updated):
            got = f.result(timeout=60.0)
            if not (np.array_equal(got, old[i]) or np.array_equal(got, new[i])):
                raise AssertionError(f"index {i} answered neither version")
        pinned_old = sum(np.array_equal(f.result(), old[i])
                         and not np.array_equal(old[i], new[i])
                         for f, i in zip(racing, updated))
        # the idle slot's compaction (the log is 2 deep)
        t = time.perf_counter()
        deadline = t + 120.0
        while fe.metrics["compacted"] < 1:
            if time.perf_counter() > deadline:
                raise AssertionError("no idle-slot compaction in 120 s")
            time.sleep(0.01)
        compact_wait_s = time.perf_counter() - t
        picks = [n + 7, n + 63] + updated[:6]
        futs = [fe.submit(f"a{c}", i) for c, i in enumerate(picks)]
        if not fe.drain(timeout=300.0):
            raise AssertionError("serve_async_live_ct: no drain")
        for f, i in zip(futs, picks):
            if not np.array_equal(f.result(timeout=60.0),
                                  live.snapshot().record_bytes(i)):
                raise AssertionError(f"serve_async_live_ct: wrong record {i}")
        if not np.array_equal(futs[0].result(), grow.raw[7]):
            raise AssertionError("appended record n + 7 is not served")
        m = fe.metrics
    scatter = scatter_rows.launches - scatter0
    if scatter <= 0 or m["compacted"] != 1 or live.log_depth != 0:
        raise AssertionError(f"serve_async_live_ct: scatter {scatter}, {m}")
    emit({"phase": "serve_async_live_ct", "n": n, "n_after": live.n,
          "record_bytes": rb, "d": cfg.d, "version": live.version,
          "deltas_queued": queued, "ingested": m["ingested"],
          "compacted": m["compacted"], "scatter_rows_launches": scatter,
          "ingest_and_lookups_s": ingest_s,
          "compaction_wait_s": compact_wait_s,
          "lookups_answering_the_pre_burst_version": int(pinned_old),
          "store": dict(live.metrics), "served": m["served"],
          "failed": m["failed"], "memory_resident_at_start": resident,
          "max_memory_allocated": torch.cuda.max_memory_allocated()})


def fleet_ct(label, pir_ct, cfg, store_, scenario, queue_limit, shed,
             smi):
    """``run_scenario`` over the CT pipeline by the card's defaults,
    every answer the pipeline hands out held against its record after the
    run (a spy on ``execute_planned`` keeps them)."""
    from repro_torch.fleet import run_scenario

    pipe = pir_ct.make_serving_pipeline(cfg, store=store_, seed=9)
    pop = pir_ct.make_fleet_population(cfg, seed=scenario.seed)
    handed = []
    real = pipe.execute_planned

    def spy(planned):
        out = real(planned)
        # (servers answered, payload rows, bucket) of a batch that went
        # to the wire; None for one the cache answered whole
        tag = None if planned.routed is None else (
            len(planned.routed.servers),
            int(planned.routed.payload.shape[0]), planned.padded)
        handed.extend((r.index, a, tag) for r, a in out)
        return out

    pipe.execute_planned = spy
    healthy = pipe.price
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rep = run_scenario(scenario, pipe, pop, queue_limit=queue_limit,
                       shed_policy=shed)
    for i, a, tag in handed:
        if not np.array_equal(a, store_.record_bytes(int(i))):
            raise AssertionError(
                f"{label}: wrong record for index {i} (servers, payload "
                f"rows, bucket of its batch: {tag})")
    slo = rep.slo
    fm = rep.frontend_metrics
    if slo["failed"] != 0 or len(handed) != slo["served"]:
        raise AssertionError(f"{label}: {slo}, {len(handed)} answers")
    if fm["accepted"] != slo["served"] + slo["refused"]:
        raise AssertionError(f"{label}: accepted {fm['accepted']} != "
                             f"served + refused ({slo})")
    line = {"phase": label, "card": smi, "scenario": rep.scenario,
            "n": store_.n, "d": cfg.d, "bucket": cfg.query_batch,
            "clients": pop.n_clients, "cache_entries": cfg.cache_entries,
            "max_wait_ms": cfg.max_wait_ms, "queue_limit": queue_limit,
            "shed_policy": shed, "arrivals": rep.arrivals,
            "wall_s": rep.wall_s, "slo": slo, "healthy_price": healthy,
            "price": rep.price, "degraded": rep.degraded,
            "remeshes": rep.remeshes, "unserviceable": rep.unserviceable,
            "d_effective": pipe.metrics["d_effective"],
            "frontend": {k: fm[k] for k in (
                "accepted", "served", "shed", "failed", "batches",
                "prefilled", "autotuned", "cache_hits")},
            "answers_checked": len(handed),
            "memory_resident_at_start": resident,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}
    return line, pipe


def async_and_fleet(pir_ct, online, store, red, small, rng, wrappers,
                    sync_sparse, smi, read_counts, reset_counts, scatter_rows):
    """The async front at the CT scale (double-buffered, single-threaded,
    against the synchronous phase's flushes), Chor and the reduced fused
    paths through it, a live store behind it, and the fleet harness: a
    Poisson scenario that loses two replicas mid-run, bursty arrivals
    against a 64-slot door, and a synthetic herd that fills it. Returns
    each path's launch counts."""
    from repro_torch.data.pipeline import pir_delta_batch
    from repro_torch.db import VersionedStore
    from repro_torch.dist.fault import pir_degraded_privacy
    from repro_torch.fleet import (
        BurstyArrivals, FaultEvent, FleetScenario, PoissonArrivals,
    )

    d = online.d
    by_path = {}
    # what earlier phases left for the collector (autotune_ct's 12.29 GB
    # of planes among it) would otherwise sit under these phases' peaks
    gc.collect()
    torch.cuda.empty_cache()
    # no cache: no banked plans, so both forms plan as serve_sparse_ct did
    plain = dataclasses.replace(online, cache_entries=0)
    runs = {}
    for form, double in (("double_buffered", True), ("single", False)):
        runs[form], by_path[f"serve_async_sparse_ct_{form}"] = serve_async(
            "serve_async_sparse_ct", pir_ct, plain, store, rng, wrappers,
            {"indices_from_mask": d, "gather_xor": d}, 256, read_counts,
            reset_counts, double_buffer=double, trace=double)
    sync_s = sync_sparse["flush_s"][-1]
    emit({"phase": "serve_async_sparse_ct", "card": smi, **{
        k: v for k, v in runs["double_buffered"].items()
        if k not in ("phase", "double_buffer")},
        "single": {k: runs["single"][k] for k in (
            "wall_s", "batches", "flushes_per_s", "lookups_per_s",
            "launches_a_batch", "memory_resident_at_start",
            "max_memory_allocated")},
        "sync": {"flush_s": sync_sparse["flush_s"],
                 "flushes_per_s": 1.0 / sync_s,
                 "lookups_per_s": online.query_batch / sync_s,
                 "max_memory_allocated":
                     sync_sparse["max_memory_allocated"]}})
    chor, by_path["serve_async_chor_ct"] = serve_async(
        "serve_async_chor_ct", pir_ct, dataclasses.replace(plain,
                                                           scheme="chor"),
        store, rng, wrappers, {"xor_fold": d}, 64, read_counts,
        reset_counts)
    emit(chor)
    reset_counts()
    serve_async_reduced(pir_ct, red, small, rng, wrappers)
    by_path["serve_async_reduced"] = read_counts()
    for name in ("fused_gather_fold", "fused_multi_gather_fold"):
        if by_path["serve_async_reduced"][name] <= 0:
            raise AssertionError(f"serve_async_reduced never launched {name}")
    reset_counts()
    serve_async_live(pir_ct, plain, store, rng, pir_delta_batch,
                     VersionedStore, scatter_rows)
    by_path["serve_async_live_ct"] = read_counts()
    gc.collect()
    torch.cuda.empty_cache()

    # the fleet: half the rate the double-buffered front sustained above
    rate = 0.5 * runs["double_buffered"]["lookups_per_s"]
    fleet_cfg = dataclasses.replace(online, cache_entries=4096,
                                    max_wait_ms=10.0, fleet_clients=1000)
    reset_counts()
    line, pipe = fleet_ct(
        "fleet_sparse_ct", pir_ct, fleet_cfg, store,
        FleetScenario(name="fleet_sparse_ct", arrivals=PoissonArrivals(rate),
                      duration_s=4.0,
                      faults=(FaultEvent(1.6, d - 2), FaultEvent(1.6, d - 1)),
                      heartbeat_timeout_s=0.1, seed=0),
        8192, "reject", smi)
    by_path["fleet_sparse_ct"] = read_counts()
    info = pir_degraded_privacy(d=d, d_a=online.d_a, failed=2,
                                scheme="sparse", n=store.n,
                                theta=online.theta)
    if (line["remeshes"] != 1 or line["d_effective"] != d - 2
            or line["degraded"] != info
            or pipe.price != (info["epsilon"], info["delta"])
            or tuple(line["price"]) != pipe.price):
        raise AssertionError(f"fleet_sparse_ct: {line}, expected {info}")
    emit({**line, "rate_qps": rate, "pir_degraded_privacy": info})
    del pipe
    # bursty arrivals at 5x the fleet's rate for 2 s, in the shape the
    # launcher's --arrivals bursty gives them (a burst of 5x the base rate
    # for the first fifth of every quarter of the run), against a door of
    # 64; whether any are shed is reported, not required
    from repro_torch.launch.fleet import build_args, make_arrivals

    bursty = make_arrivals(build_args().parse_args(
        ["--arrivals", "bursty", "--rate", str(rate), "--duration", "2.0"]))
    reset_counts()
    line, pipe = fleet_ct(
        "fleet_bursty_ct", pir_ct, fleet_cfg, store,
        FleetScenario(name="fleet_bursty_ct", arrivals=bursty,
                      duration_s=2.0, seed=1),
        64, "reject", smi)
    by_path["fleet_bursty_ct"] = read_counts()
    healthy = pipe.staged.privacy(store.n)
    if (line["remeshes"] != 0 or pipe.price != healthy
            or tuple(line["price"]) != healthy):
        raise AssertionError(f"fleet_bursty_ct: {line}")
    emit({**line, "base_qps": bursty.base_qps,
          "burst_qps": bursty.burst_qps, "period_s": bursty.period_s,
          "duty": bursty.duty})
    del pipe
    # a synthetic stress test of the shed path, not a traffic mix: the
    # same mean rate with all of it above the base rate arriving in one
    # window of well under a millisecond, so that the 64-slot door fills
    # (admission takes microseconds an item, so the bursts above never
    # fill it)
    herd_qps, period = 400_000.0, 2.0
    duty = 4.0 * rate / (herd_qps - rate)
    reset_counts()
    line, pipe = fleet_ct(
        "fleet_bursty_shed_ct", pir_ct, fleet_cfg, store,
        FleetScenario(name="fleet_bursty_shed_ct",
                      arrivals=BurstyArrivals(base_qps=rate,
                                              burst_qps=herd_qps,
                                              period_s=period, duty=duty),
                      duration_s=2.0, seed=1),
        64, "reject", smi)
    by_path["fleet_bursty_shed_ct"] = read_counts()
    if (line["slo"]["shed"] <= 0 or line["remeshes"] != 0
            or pipe.price != healthy or tuple(line["price"]) != healthy):
        raise AssertionError(f"fleet_bursty_shed_ct: {line}")
    emit({**line, "synthetic": True,
          "switch_interval_s": sys.getswitchinterval(),
          "base_qps": rate, "burst_qps": herd_qps,
          "period_s": period, "duty": duty,
          "mean_qps": rate + duty * (herd_qps - rate)})
    del pipe
    for path in ("serve_async_live_ct", "fleet_sparse_ct",
                 "fleet_bursty_ct", "fleet_bursty_shed_ct"):
        for name in ("gather_xor", "indices_from_mask"):
            if by_path[path][name] <= 0:
                raise AssertionError(f"{path} never launched {name}")
    if by_path["serve_async_live_ct"]["scatter_rows"] <= 0:
        raise AssertionError("serve_async_live_ct never launched scatter_rows")
    gc.collect()
    torch.cuda.empty_cache()
    return by_path


def check_flash(label, bh, sq, d, dtype, causal, window, dev,
                flash_attention_fwd, flash_attention_plain, plain_rows=None,
                iters=10, device_runs=0):
    """The flash kernel at one operand set against its plain version
    (``FLASH_TOL``; bf16 operands once more cast to f32, held at 1e-5, so
    the tile loop and its skips are checked without the output's
    rounding), timed beside the plain version and PyTorch's
    scaled_dot_product_attention on the same operands; with
    ``device_runs``, the card's time of one call of each (torch.profiler,
    10 calls a run) in that many runs."""
    import torch.nn.functional as F

    g = torch.Generator(device=dev).manual_seed(sq + d)
    q, k, v = (torch.randn((bh, sq, d), generator=g, device=dev).to(dtype)
               for _ in range(3))
    rows = slice(0, plain_rows or bh)

    def kernel():
        return flash_attention_fwd(q, k, v, causal=causal, window=window)

    def plain():
        return flash_attention_plain(q[rows], k[rows], v[rows], causal=causal,
                                     window=window)

    def held(q_, k_, v_, tol):
        before = dict(flash_attention_fwd.kernel_launches)
        got = flash_attention_fwd(q_, k_, v_, causal=causal,
                                  window=window)[rows]
        ran = [n for n, c in flash_attention_fwd.kernel_launches.items()
               if c != before[n]]
        want = flash_attention_plain(q_[rows], k_[rows], v_[rows],
                                     causal=causal, window=window)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if not torch.allclose(got.float(), want.float(), **tol):
            raise AssertionError(
                f"flash_attention_fwd {label} ({got.dtype}): kernel differs "
                f"from the plain version (max abs err {err}, {tol})")
        if not torch.isfinite(got).all():
            raise AssertionError(f"flash_attention_fwd {label}: non-finite "
                                 "output")
        return err, ran[0]

    tol = FLASH_TOL[dtype]
    err, kernel_name = held(q, k, v, tol)
    f32_check = None
    if dtype != torch.float32:
        # the same operands in f32 go to flash_attention.cu: this checks
        # that kernel's tile loop without the output's rounding, not the
        # tensor-core kernel's (the bf16 check above and the card tests
        # hold that one)
        f32_tol = FLASH_TOL[torch.float32]
        f32_err, f32_kernel = held(*(t.float() for t in (q, k, v)), f32_tol)
        f32_check = {"max_abs_err": f32_err, "tolerance": f32_tol,
                     "kernel": f32_kernel}
    # the same function as one PyTorch call: causal without a window as
    # is_causal, a window as a boolean band mask
    q4, k4, v4 = (t.unsqueeze(0) for t in (q, k, v))
    band = None
    if window is not None:
        qpos = torch.arange(sq, device=dev)[:, None]
        kpos = torch.arange(sq, device=dev)[None, :]
        band = (kpos <= qpos) & (kpos > qpos - window)

    def library():
        if band is not None:
            return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=band)
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)

    device = (device_runs_ms(kernel, library, kernel_name, device_runs)
              if device_runs else {})
    bound_ms, bound_by = flash_bound(bh, sq, sq, d, causal, window, dtype)
    # the same work's flops at the bf16 tensor-core peak, whatever the
    # operands' type: below bound_ms where the operands are f32
    bf16_peak_ms, bf16_peak_by = flash_bound(bh, sq, sq, d, causal, window,
                                             dtype, peak=BF16_FLOPS_PER_S)
    extra = {}
    if dtype == torch.float32:
        # what flash_attention.cu runs: three TF32 passes (3xTF32) a product
        extra["bound_at_3xtf32_ms"], extra["bound_at_3xtf32_by"] = (
            flash_bound(bh, sq, sq, d, causal, window, dtype,
                        peak=TF32_FLOPS_PER_S, passes=3))
    return {
        "label": label,
        "shape": {"bh": bh, "sq": sq, "sk": sq, "d": d,
                  "dtype": str(dtype).replace("torch.", ""), "causal": causal,
                  "window": window, "plain_rows": plain_rows or bh},
        "kernel": kernel_name, "source": CSRC + FLASH_SOURCES[kernel_name],
        "max_abs_err": err, "tolerance": tol,
        "same_operands_in_f32": f32_check,
        "ms": time_ms(kernel, iters=iters),
        "plain_ms": time_ms(plain, warmup=1, iters=2),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_at_bf16_peak_ms": bf16_peak_ms,
        "bound_at_bf16_peak_by": bf16_peak_by, **extra,
        "library_ms": time_ms(library, iters=iters),
        "library": ("scaled_dot_product_attention"
                    + (" (band mask)" if band is not None else "")),
        **device,
    }


def serve_lm_smollm(dev, card, flash, read_counts, reset_counts):
    """Full-width SmolLM-135M (30 layers, bf16, random weights from seed 0)
    through ``prefill`` + ``decode_step``: 4 requests of 4096 tokens and
    32 greedy tokens each, one request of 32 768 tokens, and the f32 model
    on the card against the same weights on the CPU. Returns each sub-path's
    launch counts."""
    from repro_torch.configs import get_arch
    from repro_torch.data import lm_batch
    from repro_torch.models import transformer as T

    cfg = get_arch("smollm-135m").CONFIG
    model = T.init_lm(torch.Generator(device=dev).manual_seed(0), cfg,
                      device=dev)
    batch, prompt, new = 4, 4096, 32
    tokens = torch.from_numpy(
        lm_batch(cfg, batch, prompt, seed=0, step=0)["tokens"]).to(dev)
    counts = {}

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    logits, cache = T.prefill(model, cfg, tokens, prompt + new)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    prefill_launches = flash.launches
    prefill_by_kernel = dict(flash.kernel_launches)
    tok = logits.argmax(-1, keepdim=True)
    out = [tok]
    t = time.perf_counter()
    for i in range(new):
        logits, cache = T.decode_step(model, cfg, cache, tok, prompt + i)
        tok = logits.argmax(-1, keepdim=True)
        out.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t
    counts["serve_lm_smollm"] = read_counts()
    if prefill_launches != cfg.n_layers or flash.launches != cfg.n_layers:
        raise AssertionError(f"serve_lm_smollm: {prefill_launches} flash "
                             f"launches in the prefill, {flash.launches} in "
                             f"all, expected {cfg.n_layers}")
    if prefill_by_kernel != {"flash_fwd_kernel": 0,
                             "flash_wgmma_kernel": cfg.n_layers}:
        raise AssertionError(f"serve_lm_smollm: the prefill's flash launches "
                             f"by kernel are {prefill_by_kernel}, expected "
                             f"all {cfg.n_layers} on flash_wgmma_kernel")
    generated = torch.cat(out, dim=1)
    if not (torch.isfinite(logits).all() and generated.min() >= 0
            and generated.max() < cfg.vocab
            and generated.shape == (batch, new + 1)):
        raise AssertionError("serve_lm_smollm: bad logits or tokens")
    line = {
        "phase": "serve_lm_smollm", "card": card, "config": cfg.name,
        "n_layers": cfg.n_layers, "d_model": cfg.d_model, "heads":
        [cfg.n_heads, cfg.n_kv_heads], "vocab": cfg.vocab, "dtype": cfg.dtype,
        "requests": batch, "prompt": prompt, "new_tokens": new,
        "prefill_s": prefill_s,
        "prefill_tokens_per_s": batch * prompt / prefill_s,
        "decode_ms_per_token": decode_s / new * 1e3,
        "decode_tokens_per_s": batch * new / decode_s,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "flash_attention_fwd_launches_per_prefill": prefill_launches,
        "flash_kernel_launches_per_prefill": prefill_by_kernel,
        "launches": counts["serve_lm_smollm"],
    }
    # where the device time goes (measurement runs after the counts are
    # read): one more prefill, and one decode step that rewrites the last
    # position
    groups = {"flash_wgmma_kernel": ["flash_wgmma_kernel"],
              "flash_fwd_kernel": ["flash_fwd_kernel"],
              "matmul": ["gemm", "Gemm", "nvjet", "cutlass", "xmma"]}
    line["split_prefill"] = device_split(
        lambda: T.prefill(model, cfg, tokens, prompt + new), groups)
    line["split_decode_step"] = device_split(
        lambda: T.decode_step(model, cfg, cache, tok, prompt + new - 1),
        groups)
    del cache, logits

    # one request at the prefill_32k length (its batch of 32 cut to 1)
    long = 32768
    tokens = torch.from_numpy(
        lm_batch(cfg, 1, long, seed=0, step=1)["tokens"]).to(dev)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    logits, cache = T.prefill(model, cfg, tokens, long)
    torch.cuda.synchronize()
    line["prefill_32k"] = {
        "tokens": long, "prefill_s": time.perf_counter() - t,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "flash_attention_fwd_launches": flash.launches,
        "flash_kernel_launches": dict(flash.kernel_launches),
    }
    counts["serve_lm_smollm_32k"] = read_counts()
    if (flash.launches != cfg.n_layers
            or flash.kernel_launches["flash_wgmma_kernel"] != cfg.n_layers
            or not torch.isfinite(logits).all()):
        raise AssertionError("serve_lm_smollm 32k: bad launches or logits "
                             f"({dict(flash.kernel_launches)})")
    del cache, logits, tokens

    # the model in float32 with the same weights: the card (flash kernel)
    # against the CPU (the plain path), one 256-token request
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    card = T.TransformerLM(model.tree(), cfg32).float()
    host = T.TransformerLM(model.tree(), cfg32).to("cpu").float()
    tokens = lm_batch(cfg, 1, 256, seed=0, step=2)["tokens"]
    reset_counts()
    got, _ = T.prefill(card, cfg32, tokens, 256)
    torch.cuda.synchronize()
    counts["serve_lm_f32_check"] = read_counts()
    if counts["serve_lm_f32_check"]["flash_fwd_kernel"] != cfg.n_layers:
        raise AssertionError("serve_lm_smollm f32: the prefill's flash "
                             "launches did not all run flash_fwd_kernel: "
                             f"{counts['serve_lm_f32_check']}")
    want, _ = T.prefill(host, cfg32, tokens, 256)
    got = got.cpu()
    err = float((got - want).abs().max())
    same_argmax = bool(torch.equal(got.argmax(-1), want.argmax(-1)))
    if not torch.allclose(got, want, rtol=1e-3, atol=1e-3) or not same_argmax:
        raise AssertionError(f"serve_lm_smollm f32: card vs CPU max abs err "
                             f"{err}, argmax equal {same_argmax}")
    top2 = torch.topk(want, 2, dim=-1).values
    line["f32_card_vs_cpu"] = {
        "tokens": 256, "max_abs_err": err, "tolerance": {"rtol": 1e-3,
                                                          "atol": 1e-3},
        "argmax_equal": same_argmax,
        "top2_margin": float((top2[:, 0] - top2[:, 1]).min()),
        "flash_attention_fwd_launches": counts["serve_lm_f32_check"][
            "flash_attention_fwd"],
        "flash_kernel_launches": {
            n: counts["serve_lm_f32_check"][n] for n in FLASH_SOURCES},
    }
    emit(line)
    del model, card, host
    torch.cuda.empty_cache()
    return counts


def serve_private_bert4rec(dev, card, flash, fold, read_counts,
                           reset_counts):
    """Full-width BERT4Rec (random weights from seed 0) scoring 32 users
    whose item histories are fetched by Sparse-PIR through PrivateEmbedding
    (the config's private_lookup_d/da/theta), bit-equal to the plain
    lookup. Returns the path's launch counts."""
    from repro_torch.configs import get_arch
    from repro_torch.core import PrivateEmbedding
    from repro_torch.core.accounting import PrivacyBudget
    from repro_torch.data import bert4rec_batch
    from repro_torch.models import recsys as R

    cfg = get_arch("bert4rec").CONFIG
    model = R.bert4rec_init(torch.Generator(device=dev).manual_seed(0), cfg,
                            device=dev)
    users = 32
    seq = torch.from_numpy(
        bert4rec_batch(cfg, users, seed=0, step=0)["seq"]).to(dev)
    budget = PrivacyBudget(epsilon_limit=1e9)
    pe = PrivateEmbedding.create(
        model.tree()["embed"], scheme="sparse", d=cfg.private_lookup_d,
        d_a=cfg.private_lookup_da, theta=cfg.private_lookup_theta,
        budget=budget)
    gen = torch.Generator(device=dev).manual_seed(1)

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    private = R.bert4rec_logits(model, cfg, seq,
                                lookup_fn=lambda table, ids: pe.lookup(gen, ids))
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    spent = budget.spent_epsilon
    # the d answers of the batch's 6400 lookups each take the table form
    if (flash.launches != cfg.n_blocks
            or fold.launches != cfg.private_lookup_d
            or counts["xor_fold_table"] != cfg.private_lookup_d):
        raise AssertionError(f"serve_private_bert4rec: launches {counts}")
    plain = R.bert4rec_logits(model, cfg, seq)
    err = max_abs_err(private.view(torch.int32), plain.view(torch.int32))
    split = device_split(
        lambda: R.bert4rec_logits(
            model, cfg, seq, lookup_fn=lambda table, ids: pe.lookup(gen, ids)),
        {"flash_fwd_kernel": ["flash_fwd_kernel"],
         "flash_wgmma_kernel": ["flash_wgmma_kernel"],
         "xor_fold": ["xor_fold"], "sort": ["sort", "Sort"],
         "matmul": ["gemm", "Gemm", "nvjet", "cutlass", "xmma"]})
    if err != 0 or private.shape != (users, R.bert4rec_vocab(cfg)):
        raise AssertionError("serve_private_bert4rec: private logits differ "
                             "from the plain-lookup logits")
    emit({
        "phase": "serve_private_bert4rec", "card": card, "config": cfg.name,
        "embed_dim": cfg.embed_dim, "n_blocks": cfg.n_blocks,
        "n_heads": cfg.n_heads, "seq_len": cfg.seq_len,
        "items_table": [R.bert4rec_vocab(cfg), cfg.embed_dim],
        "store_bytes": pe._store.nbytes, "users": users,
        "lookups": users * cfg.seq_len, "scheme": "sparse",
        "d": cfg.private_lookup_d, "d_a": cfg.private_lookup_da,
        "theta": cfg.private_lookup_theta, "batch_s": batch_s,
        "epsilon_per_lookup": pe.epsilon_per_lookup(),
        "epsilon_spent": spent,
        "private_equals_plain_bits": err == 0,
        "max_memory_allocated": peak, "launches": counts,
        "split_batch": split,
    })
    del model, pe, private, plain
    torch.cuda.empty_cache()
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2

    from repro_torch.configs import pir_ct
    from repro_torch.db import make_synthetic_store, packing
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.fused import (
        STAGINGS, _launch as fused_launch, fused_block_w, fused_gather_fold,
        fused_gather_fold_plain, fused_multi_gather_fold,
        fused_multi_gather_fold_plain, fused_schedule, fused_smem_budget,
        jagged_row_mask,
    )
    from repro_torch.kernels.gather_xor import gather_xor, indices_from_mask
    from repro_torch.kernels.parity_matmul import (
        parity_matmul, parity_matmul_packed,
    )
    from repro_torch.kernels.flash_attention import (
        flash_attention_fwd, flash_attention_plain,
    )
    from repro_torch.kernels.scatter import scatter_rows, scatter_rows_plain
    from repro_torch.kernels.xor_fold import xor_fold, xor_fold_plain
    from repro_torch.serve import ShardedBackend

    t_script = time.perf_counter()
    dev = torch.device("cuda")
    # float32 products in full float32 (the f32 checks hold 1e-5 and 1e-3)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wrappers = {
        "xor_fold": xor_fold, "gather_xor": gather_xor,
        "fused_gather_fold": fused_gather_fold,
        "parity_matmul": parity_matmul,
        "parity_matmul_packed": parity_matmul_packed,
        "scatter_rows": scatter_rows,
        "fused_multi_gather_fold": fused_multi_gather_fold,
        "flash_attention_fwd": flash_attention_fwd,
        "indices_from_mask": indices_from_mask,
    }

    def reset_counts():
        for fn in wrappers.values():
            fn.launches = 0
        for counts in (flash_attention_fwd.kernel_launches,
                       xor_fold.kernel_launches):
            for name in counts:
                counts[name] = 0

    def read_counts():
        # each wrapper's count, flash_attention_fwd's by kernel and
        # xor_fold's by form
        return {**{k: f_.launches for k, f_ in wrappers.items()},
                **flash_attention_fwd.kernel_launches,
                **{f"xor_fold_{k}": c
                   for k, c in xor_fold.kernel_launches.items()}}

    # ------------------------------------------------------------ 1 device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    # ------------------------------------------------------------- 2 build
    _build.library()
    report = _build.build_report()
    emit({"phase": "build", **report})

    cfg = pir_ct.CONFIG
    n, rb = cfg.n_records, cfg.record_bytes
    rng = np.random.default_rng(7)
    t0 = time.perf_counter()
    store = make_synthetic_store(n, rb, seed=0, device=dev)
    w = store.words
    emit({"phase": "store", "n": n, "record_bytes": rb, "words": w,
          "bytes": store.nbytes, "seconds": time.perf_counter() - t0})

    # ----------------------------------------------------------- 3 kernels
    rows = []
    q = 8
    mask = random_mask(rng, q, n, 0.5, dev)
    # xor_fold: row 1 at the lookup path's batch (q 8, the streaming
    # form), with the switch sweep between the forms; row 1' the private
    # BERT4Rec path's operands (6400 queries over a 26 752-row store of 64
    # words), riding along under "at_bert4rec"; row 1'' the CT store at a
    # Chor bucket of 128 (the table form), its own row. Every row holds
    # and times both forms.
    rows.append(check_kernel(
        "xor_fold", {"n": n, "W": w, "q": q, "density": 0.5},
        lambda: xor_fold(store.packed, mask),
        lambda: xor_fold_plain(store.packed, mask),
        fold_bound(store.packed, mask),
        "xor_fold.cu", "src/repro/kernels/xor_fold.py:79",
        also=lambda want: fold_forms(store.packed, mask, want),
    ))
    rows[-1]["switch_sweep"] = fold_switch_sweep(
        store.packed, rng, dev, (8, 9, 16, 32, 64, 96, 128, 256))
    bdb, bmask = bert4rec_fold_operands(dev)
    at_bert4rec = check_kernel(
        "xor_fold", {"n": bdb.shape[0], "W": bdb.shape[1],
                     "q": bmask.shape[0], "mask_dtype": str(bmask.dtype),
                     "density": int(torch.count_nonzero(bmask))
                     / bmask.numel()},
        lambda: xor_fold(bdb, bmask), lambda: xor_fold_plain(bdb, bmask),
        fold_bound(bdb, bmask),
        "xor_fold.cu", "src/repro/kernels/xor_fold.py:79", plain_iters=1,
        also=lambda want: fold_forms(bdb, bmask, want))
    # the card's own time of one call (the mask packing apart), beside the
    # event time the host's launches may set
    split = device_split(lambda: [xor_fold(bdb, bmask) for _ in range(10)],
                         {"pack": ["xor_fold_pack"], "fold": ["xor_fold"]})
    at_bert4rec["device_ms"] = split["device_ms"] / 10
    at_bert4rec["device_ms_by_kernel"] = {
        k: v / 10 for k, v in split["ms"].items()}
    rows[-1]["at_bert4rec"] = {
        k: at_bert4rec[k] for k in ("shape", "max_abs_err", "ms", "device_ms",
                                    "device_ms_by_kernel", "plain_ms",
                                    "bound_ms", "bound_by", "form", "forms")}
    del bdb, bmask, at_bert4rec
    torch.cuda.empty_cache()
    mask128 = random_mask(rng, 128, n, 0.5, dev)
    rows.append(check_kernel(
        "xor_fold_table", {"n": n, "W": w, "q": 128, "density": 0.5},
        lambda: xor_fold(store.packed, mask128),
        lambda: xor_fold_plain(store.packed, mask128),
        fold_bound(store.packed, mask128),
        "xor_fold.cu", "src/repro/kernels/xor_fold.py:79", plain_iters=1,
        also=lambda want: fold_forms(store.packed, mask128, want)))
    if rows[-1]["form"] != "table":
        raise AssertionError("xor_fold at q 128 does not take the table form")
    del mask128
    torch.cuda.empty_cache()

    # gather_xor at the lookup path's batch (q 8), serve_multi_ct's flat
    # bucket (q 32) and one query; the row is q 8's, the others ride along
    gather_rows = [check_gather(store.packed, qg, cfg.theta, rng, dev,
                                sweep=qg == 8) for qg in (8, 32, 1)]
    for key, r in (("at_q32", gather_rows[1]), ("at_q1", gather_rows[2])):
        gather_rows[0][key] = {k: r[k] for k in (
            "shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "dense_fold_same_masks_ms", "shuffled")}
    gather_rows[0]["build"] = [
        {k: e[k] for k in ("entry", "registers", "smem_bytes",
                           "spill_store_bytes", "spill_load_bytes")}
        for e in report["kernels"] if e["source"] == "gather_xor.cu"]
    rows.append(gather_rows[0])
    rows.append(check_indices_from_mask(n, cfg.theta, rng, dev))
    rows[-1]["build"] = [
        {k: e[k] for k in ("entry", "registers", "smem_bytes",
                           "spill_store_bytes", "spill_load_bytes")}
        for e in report["kernels"] if e["source"] == "indices_from_mask.cu"]
    del mask

    # fused: the reduced config's shape (its serving path) and the largest
    # n the shared-memory gate admits at the full record width, at the
    # lookup batch (q 8) and at q 32; both grid orders through the wrapper
    # and each staging path forced, each held bit for bit and timed by
    # events and by the card's own time
    budget = fused_smem_budget(dev)
    red = pir_ct.reduced()
    small = make_synthetic_store(red.n_records, red.record_bytes, seed=0,
                                 device=dev)
    n_gate = budget // (8 * 4)
    fused_shapes = [(red.n_records, red.record_bytes // 4), (n_gate, w)]
    fused_build = [
        {k: e[k] for k in ("source", "entry", "registers", "smem_bytes",
                           "spill_store_bytes", "spill_load_bytes")}
        for e in report["kernels"] if e["source"].startswith("fused_")]
    fused_rows = []
    for fn_, fw in fused_shapes:
        fbw = fused_block_w(fn_, fw, device=dev)
        if fbw == 0:
            raise AssertionError(f"fused gate refuses n={fn_}, W={fw}")
        fdb = store.packed[:fn_, :fw].contiguous()
        fm = ops.sparse_index_budget(fn_, cfg.theta)
        by_q = []
        for fq in (q, 32):
            fidx = indices_from_mask(
                random_mask(rng, fq, fn_, cfg.theta, dev), fm)
            fdistinct = int(torch.unique(fidx[fidx >= 0]).numel())
            want = gather_xor(fdb, fidx)
            if max_abs_err(fused_gather_fold_plain(fdb, fidx), want) != 0:
                raise AssertionError("fused plain version != gather_xor")
            by_q.append(check_kernel(
                "fused_gather_fold",
                {"n": fn_, "W": fw, "q": fq, "m": fm,
                 "distinct_rows": fdistinct, "block_w": fbw,
                 "grid_order": "qw", "smem_budget": budget,
                 "schedule": dict(fused_schedule(
                     fn_, fw, fq, fbw, budget=budget))},
                lambda: fused_gather_fold(fdb, fidx, block_w=fbw),
                lambda: fused_gather_fold_plain(fdb, fidx),
                # the function is gather_xor's: only the distinct live rows
                # need to move, whatever the kernel stages
                ((fdistinct * fw * 4 + fq * fm * 4 + fq * fw * 4)
                 / HBM_BYTES_PER_S * 1e3, "bytes"),
                "fused_gather_fold.cu", "src/repro/kernels/fused.py:190",
                iters=50, plain_iters=5,
                also=lambda want_: {"forms": fused_runs(fused_forms(
                    fused_gather_fold, fused_launch, fused_schedule,
                    STAGINGS, fdb, fidx, None, 1, fbw, ("qw", "wq"),
                    budget), want_)},
            ))
            by_q[-1]["device_ms"] = by_q[-1]["forms"]["qw"]["device_ms"]
        by_q[0]["at_q32"] = {k: by_q[1][k] for k in (
            "shape", "max_abs_err", "ms", "device_ms", "plain_ms",
            "bound_ms", "bound_by", "forms")}
        fused_rows.append(by_q[0])
    # the row of the kernel is the main path's shape; the widest slab the
    # gate admits rides along under "at_gate", with what the build made of
    # the fused kernels and how many clusters of 8 CTAs the card holds
    fused_rows[0]["at_gate"] = {
        k: fused_rows[1][k]
        for k in ("shape", "max_abs_err", "ms", "device_ms", "plain_ms",
                  "bound_ms", "bound_by", "forms", "at_q32")}
    fused_rows[0]["build"] = fused_build
    lib = _build.library()
    fused_rows[0]["active_clusters"] = {
        f"8 CTAs of {b} B": lib.pir_fused_active_clusters(8, b)
        for b in (fused_rows[0]["shape"]["schedule"]["smem_bytes"], budget)}
    if min(fused_rows[0]["active_clusters"].values()) <= 0:
        raise AssertionError("the card holds no cluster of 8 fused CTAs: "
                             f"{fused_rows[0]['active_clusters']}")
    rows.append(fused_rows[0])

    # parity: the shape the main path gives it (the reduced store, one
    # bucket of 128), the full 12 288 bit columns with n cut to 65 536, and
    # the whole CT store (12.29 GB of planes, built once: the crossover
    # below reads them too, then they are freed)
    n_cut, qp = 65536, 128
    cut_db = store.packed[:n_cut].contiguous()
    cut_planes = packing.bitplanes_from_packed(cut_db)
    full_planes = packing.bitplanes_from_packed(store.packed)
    parity_rows = []
    for pdb, planes, extra, iters in (
            (small.packed, packing.bitplanes_from_packed(small.packed), {},
             50),
            (cut_db, cut_planes, {"n_cut_from": n}, 5),
            (store.packed, full_planes, {}, 5)):
        pmask = random_mask(rng, qp, pdb.shape[0], 0.5, dev)
        planes_rows = planes.contiguous()
        parity_rows.append(check_parity(
            pmask, planes, planes_rows, extra, iters=iters,
            plain_iters=1 if planes is full_planes else 2,
            fp32_library=planes is not full_planes))
        del planes_rows
        torch.cuda.empty_cache()
        # the parity path answers what the fold answers
        if max_abs_err(ops.server_answer_parity(planes, pmask),
                       xor_fold(pdb, pmask)) != 0:
            raise AssertionError("parity path != fold path")
        del pmask
    # the row of the kernel is the main path's shape; the full width and
    # the CT scale ride along, with what the build made of the kernel
    for key, row in (("at_full_width", parity_rows[1]),
                     ("at_ct_scale", parity_rows[2])):
        parity_rows[0][key] = {
            k: row[k] for k in ("shape", "max_abs_err", "ms", "device_ms",
                                "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "library_ms_int8",
                                "uint8_form", "rows_layout")}
    parity_rows[0]["build"] = [
        {k: e[k] for k in ("entry", "registers", "smem_bytes",
                           "spill_store_bytes", "spill_load_bytes")}
        for e in report["kernels"] if "parity_kernel" in e["entry"]]
    parity_rows[0]["sass"] = tensor_core_sass(report["library"],
                                              "parity_kernel")
    if not parity_rows[0]["sass"] or not all(
            c.get("IGMMA", 0) + c.get("IMMA", 0) > 0
            for c in parity_rows[0]["sass"].values()):
        raise AssertionError("parity_matmul's SASS has no integer tensor-"
                             f"core instruction: {parity_rows[0]['sass']}")
    rows.append(parity_rows[0])

    # scatter_rows: the ingest chunk (4096 unique rows) into the CT store
    m_up = 4096
    up_rows = torch.from_numpy(
        rng.choice(n, size=m_up, replace=False).astype(np.int32)).to(dev)
    up_vals = torch.randint(-(2**31), 2**31 - 1, (m_up, w),
                            dtype=torch.int32, device=dev)
    up_rows_long = up_rows.long()
    db_rows_before = store.packed[up_rows_long].clone()
    rows.append(check_kernel(
        "scatter_rows",
        {"n": n, "W": w, "m": m_up, "unique": True, "dtype": "int32"},
        lambda: scatter_rows(store.packed, up_rows, up_vals),
        lambda: scatter_rows_plain(store.packed, up_rows, up_vals),
        # functional: every row of out is written once and read once, from
        # db (untouched rows) or from vals (written rows), plus the row ids
        ((2 * n * w * 4 + m_up * 4) / HBM_BYTES_PER_S * 1e3, "bytes"),
        "scatter_rows.cu", "src/repro/kernels/scatter.py:100",
        library_fn=lambda: store.packed.index_copy(0, up_rows_long, up_vals),
    ))
    # the kernel and index_copy in turns in this one process (library,
    # kernel, kernel, library; CUDA events, mean of 10 after 2 warm-ups)
    rows[-1]["alternating_ms"] = [
        [name, time_ms(fn, iters=10)] for name, fn in (
            ("index_copy",
             lambda: store.packed.index_copy(0, up_rows_long, up_vals)),
            ("scatter_rows",
             lambda: scatter_rows(store.packed, up_rows, up_vals)),
            ("scatter_rows",
             lambda: scatter_rows(store.packed, up_rows, up_vals)),
            ("index_copy",
             lambda: store.packed.index_copy(0, up_rows_long, up_vals)))]
    # duplicate rows with different values: the last write wins, and the
    # input is never written
    dup = torch.tensor([7, 11, 7, 7, 11, n - 1, 7], dtype=torch.int32,
                       device=dev)
    dup_vals = torch.arange(dup.numel() * w, dtype=torch.int32,
                            device=dev).reshape(-1, w)
    got = scatter_rows(store.packed, dup, dup_vals)
    last = {}
    for i, r in enumerate(dup.tolist()):
        last[r] = i
    for r, i in last.items():
        if not torch.equal(got[r], dup_vals[i]):
            raise AssertionError(f"scatter_rows: row {r} is not its last write")
    rows[-1]["duplicates_last_write"] = max_abs_err(
        got, scatter_rows_plain(store.packed, dup, dup_vals))
    if rows[-1]["duplicates_last_write"] != 0:
        raise AssertionError("scatter_rows differs on duplicate rows")
    if not torch.equal(store.packed[up_rows_long], db_rows_before):
        raise AssertionError("scatter_rows wrote into its input")
    del got, up_vals, db_rows_before
    torch.cuda.empty_cache()

    # fused_multi_gather_fold: timed at the operands its serving path gives
    # it (8 requests of k_max = 4 rows, every row live: the multi layout
    # pads with real dummy queries), at the reduced config's shape and at
    # the widest slab the gate admits; a jagged case (a zero-count request,
    # garbage in dead rows) is checked beside it at both shapes
    def multi_case(fdb, fn_, counts, k_max):
        fm = ops.sparse_index_budget(fn_, cfg.theta)
        r_count = len(counts)
        idx = indices_from_mask(
            random_mask(rng, r_count * k_max, fn_, cfg.theta, dev), fm)
        off = torch.from_numpy(
            np.cumsum([0] + list(counts)).astype(np.int32)).to(dev)
        live = jagged_row_mask(off, k_max, r_count * k_max)
        # dead rows hold live-looking garbage the descriptor must silence
        garbage = torch.randint(0, fn_, idx.shape, dtype=torch.int32,
                                device=dev)
        idx = torch.where(live[:, None], idx, garbage).contiguous()
        named = idx[live]
        distinct = int(torch.unique(named[named >= 0]).numel())
        live_rows = int(live.sum())
        bound = ((distinct * fdb.shape[1] * 4 + live_rows * fm * 4
                  + (r_count + 1) * 4 + r_count * k_max * fdb.shape[1] * 4)
                 / HBM_BYTES_PER_S * 1e3, "bytes")
        return idx, off, live, fm, distinct, bound

    k_max_m = 4
    path_counts = (k_max_m,) * 8
    jagged_counts = (3, 1, 0, 4, 2, 4, 1, 2)
    multi_rows = []
    for fn_, fw in fused_shapes:
        fdb = store.packed[:fn_, :fw].contiguous()
        fbw = fused_block_w(fn_, fw, device=dev)
        for counts in (jagged_counts, path_counts):
            idx, off, live, fm, distinct, bound = multi_case(
                fdb, fn_, counts, k_max_m)
            by_order = [
                fused_multi_gather_fold(fdb, idx, off, k_max=k_max_m,
                                        block_w=fbw, grid_order=go)
                for go in ("rw", "wr")]
            if max_abs_err(*by_order) != 0:
                raise AssertionError("fused_multi rw and wr differ")
            if max_abs_err(by_order[0], gather_xor(
                    fdb, torch.where(live[:, None], idx, -1))) != 0:
                raise AssertionError(
                    "fused_multi != gather_xor of the masked rows")
            if int(by_order[0][~live].abs().sum()) != 0:
                raise AssertionError("fused_multi: a dead row is not zero")
            err = max_abs_err(by_order[0], fused_multi_gather_fold_plain(
                fdb, idx, off, k_max_m))
            if err != 0:
                raise AssertionError(f"fused_multi {counts} differs from "
                                     f"the plain version ({err})")
            if counts is jagged_counts:
                jagged_err = err
            del by_order
        multi_rows.append(check_kernel(
            "fused_multi_gather_fold",
            {"n": fn_, "W": fw, "requests": len(path_counts),
             "counts": "all live", "k_max": k_max_m, "m": fm,
             "distinct_rows": distinct, "block_w": fbw, "grid_order": "rw",
             "smem_budget": budget, "schedule": dict(fused_schedule(
                 fn_, fw, len(path_counts) * k_max_m, fbw, grid_order="rw",
                 k_max=k_max_m, budget=budget))},
            lambda: fused_multi_gather_fold(fdb, idx, off, k_max=k_max_m,
                                            block_w=fbw),
            lambda: fused_multi_gather_fold_plain(fdb, idx, off, k_max_m),
            bound, "fused_multi_gather_fold.cu",
            "src/repro/kernels/fused.py:302", iters=50, plain_iters=5,
            also=lambda want_: {"forms": fused_runs(fused_forms(
                fused_multi_gather_fold, fused_launch, fused_schedule,
                STAGINGS, fdb, idx, off, k_max_m, fbw, ("rw", "wr"),
                budget), want_)},
        ))
        multi_rows[-1]["device_ms"] = multi_rows[-1]["forms"]["rw"][
            "device_ms"]
        multi_rows[-1]["jagged"] = {"counts": list(jagged_counts),
                                    "dead_rows": "garbage",
                                    "max_abs_err": jagged_err}
    multi_rows[0]["at_gate"] = {
        k: multi_rows[1][k]
        for k in ("shape", "max_abs_err", "ms", "device_ms", "plain_ms",
                  "bound_ms", "bound_by", "forms", "jagged")}
    rows.append(multi_rows[0])

    # flash_attention_fwd at the operands of its paths: (a) the LM prefill
    # (4 requests x 9 heads, 4096 tokens, head dim 64, bf16, causal), (b)
    # the same with gemma-2's 1024-token window, (c) BERT4Rec (32 users x 2
    # heads, 200 items, head dim 32, f32, bidirectional), (d) the
    # prefill_32k length (batch cut to 1; the plain version is held on 1 of
    # the 9 rows: the full score matrix does not fit), (e) the LM's f32
    # card-vs-CPU check (9 heads, 256 tokens, head dim 64, f32, causal: 30
    # launches a prefill), (f) (a)'s operands in f32
    flash_sets = [
        check_flash("a_lm_prefill", 4 * 9, 4096, 64, torch.bfloat16, True,
                    None, dev, flash_attention_fwd, flash_attention_plain),
        check_flash("b_lm_prefill_window_1024", 4 * 9, 4096, 64,
                    torch.bfloat16, True, 1024, dev, flash_attention_fwd,
                    flash_attention_plain),
        check_flash("c_bert4rec", 32 * 2, 200, 32, torch.float32, False,
                    None, dev, flash_attention_fwd, flash_attention_plain,
                    device_runs=3),
        check_flash("d_lm_prefill_32k", 9, 32768, 64, torch.bfloat16, True,
                    None, dev, flash_attention_fwd, flash_attention_plain,
                    plain_rows=1, iters=3),
        check_flash("e_lm_f32_check", 9, 256, 64, torch.float32, True, None,
                    dev, flash_attention_fwd, flash_attention_plain,
                    device_runs=3),
        check_flash("f_lm_prefill_f32", 4 * 9, 4096, 64, torch.float32, True,
                    None, dev, flash_attention_fwd, flash_attention_plain,
                    device_runs=3),
    ]
    for fs in flash_sets:
        want = ("flash_fwd_kernel" if fs["shape"]["dtype"] == "float32"
                else "flash_wgmma_kernel")
        checked = [fs["kernel"]] + ([fs["same_operands_in_f32"]["kernel"]]
                                    if fs["same_operands_in_f32"] else [])
        if checked != [want] + ["flash_fwd_kernel"] * (len(checked) - 1):
            raise AssertionError(f"flash {fs['label']} ran {checked}, "
                                 f"expected {want}")
    flash_row = {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": flash_sets[0]["source"],
        "replaces": "src/repro/kernels/flash_attention.py:111", "launches": 0,
        **{k: flash_sets[0][k] for k in (
            "shape", "kernel", "max_abs_err", "tolerance", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "library")},
        "operand_sets": flash_sets,
    }
    rows.append(flash_row)
    # the f32 kernel (flash_attention.cu) on its own row, at (c), with its
    # own counter; it runs on the tensor cores (mma.sync in TF32)
    f32_set = next(fs for fs in flash_sets if fs["label"] == "c_bert4rec")
    runs = f32_set["kernel_device_ms_runs"]
    f32_row = {
        "name": "flash_attention_fwd_f32", "counter": "flash_fwd_kernel",
        "route": "cuda", "source": f32_set["source"],
        "replaces": "src/repro/kernels/flash_attention.py:111", "launches": 0,
        **{k: f32_set[k] for k in (
            "shape", "kernel", "max_abs_err", "tolerance", "ms", "plain_ms",
            "bound_ms", "bound_by", "bound_at_3xtf32_ms", "library_ms",
            "library")},
        "device_ms": sorted(runs)[len(runs) // 2] if runs else None,
        "sass": tensor_core_sass(report["library"], "flash_fwd_kernel"),
    }
    if not f32_row["sass"] or not all(
            c.get("HMMA", 0) + c.get("HGMMA", 0) > 0
            for c in f32_row["sass"].values()):
        raise AssertionError("flash_fwd_kernel's SASS has no tensor-core "
                             f"instruction: {f32_row['sass']}")
    rows.append(f32_row)

    emit({"phase": "kernels", "card": smi, "checked": [
        {k: r[k] for k in ("name", "shape", "ms", "bound_ms", "plain_ms",
                           "device_ms", "library_ms", "library_ms_int8",
                           "max_abs_err", "form", "forms", "switch_sweep",
                           "uint8_form", "rows_layout",
                           "at_bert4rec", "at_gate", "at_full_width",
                           "at_ct_scale", "at_q32", "at_q1", "shuffled",
                           "active_clusters",
                           "schedules_ms", "dense_fold_same_masks_ms",
                           "edge_cases", "build", "sass",
                           "duplicates_last_write", "alternating_ms",
                           "jagged", "operand_sets")
         if k in r} for r in rows]})

    # the fold against the parity path across scheduler buckets, at the
    # full record width, with n cut to 65 536 and at the whole CT store
    emit({"phase": "crossover", "card": smi, "sizes": [
        crossover(cut_db, cut_planes, (8, 16, 32, 64, 128, 256, 512, 1024),
                  rng, dev, ops.parity_crossover_batch(n_cut, rb * 8)),
        crossover(store.packed, full_planes, (8, 32, 64, 128, 256, 1024),
                  rng, dev, ops.parity_crossover_batch(n, rb * 8)),
    ]})
    del cut_planes, full_planes, cut_db, planes, pdb
    torch.cuda.empty_cache()

    # --------------------------------------------------- 4-6 the main path
    reset_counts()
    deferred = []

    def serve(label, cfg_, store_, flushes, batch, expect_kernel,
              expect_path, backend=None, breakdown=False, expect_also=()):
        kw = {"backend": backend} if backend is not None else {}
        at_start = {k: f_.launches for k, f_ in wrappers.items()}
        pipe = pir_ct.make_serving_pipeline(
            cfg_, store=store_, device=dev, seed=3, **kw)
        times = []
        served = 0
        torch.cuda.reset_peak_memory_stats()

        def submit_batch():
            picks = rng.integers(0, store_.n, size=batch)
            for c, i in enumerate(picks):
                if not pipe.submit(f"client-{c}", int(i)):
                    raise AssertionError("budget refused a query")
            return picks

        def check(out, picks):
            for c, i in enumerate(picks):
                if not np.array_equal(out[f"client-{c}"],
                                      store_.record_bytes(int(i))):
                    raise AssertionError(
                        f"{label}: wrong record for index {int(i)}")

        def per_batch(before, what):
            for k in (expect_kernel,) + tuple(expect_also):
                grew = wrappers[k].launches - before[k]
                if grew != cfg_.d:
                    raise AssertionError(
                        f"{label}: {k} launched {grew} times in {what}, "
                        f"expected d={cfg_.d}")

        for f in range(flushes):
            before = {k: f_.launches for k, f_ in wrappers.items()}
            picks = submit_batch()
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = pipe.flush()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            check(out, picks)
            served += batch
            per_batch(before, "one batch")
        if pipe.backend.path_counts[expect_path] != cfg_.d * flushes:
            raise AssertionError(f"{label}: {pipe.backend.path_counts}")
        line = {
            "phase": label, "scheme": cfg_.scheme, "n": store_.n,
            "record_bytes": cfg_.record_bytes, "d": cfg_.d,
            "batch": batch, "flushes": flushes, "served": served,
            "flush_s": times, "path_counts": dict(pipe.backend.path_counts),
            "backend": pipe.backend.backend_name,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "target_batch": pipe.scheduler.target_batch,
            "launches": {k: f_.launches for k, f_ in wrappers.items()},
        }
        if breakdown:
            # one more batch through the pipeline's own entry points, cut
            # into its phases with a synchronisation after each
            before = {k: f_.launches for k, f_ in wrappers.items()}
            picks = submit_batch()
            cut = pipe.take_batch()
            torch.cuda.synchronize()
            t = time.perf_counter()
            planned = pipe.plan_requests(cut)
            torch.cuda.synchronize()
            plan_s = time.perf_counter() - t
            t = time.perf_counter()
            results = pipe.execute_planned(planned)
            torch.cuda.synchronize()
            execute_s = time.perf_counter() - t
            check({r.client: a for r, a in results}, picks)
            per_batch(before, "the batch cut into phases")
            line["breakdown"] = {"plan_s": plan_s, "execute_s": execute_s}
            line["launches"] = {k: f_.launches for k, f_ in wrappers.items()}
            # steps of this batch re-run outside the entry points are
            # measurement, not the main path: they wait until the main
            # path's launch counts have been read
            deferred.append((label, pipe, planned))
        line["launches_this_phase"] = {
            k: f_.launches - at_start[k] for k, f_ in wrappers.items()
            if f_.launches != at_start[k]}
        emit(line)
        return line

    online = dataclasses.replace(cfg, query_batch=8)
    sync_sparse = serve("serve_sparse_ct", online, store, 2, 8, "gather_xor",
                        "sparse", breakdown=True,
                        expect_also=("indices_from_mask",))
    serve("serve_chor_ct", dataclasses.replace(online, scheme="chor"),
          store, 2, 8, "xor_fold", "fold", breakdown=True)
    serve("serve_reduced_sparse", red, small, 2, 8, "fused_gather_fold",
          "sparse")
    big_bucket = dataclasses.replace(red, scheme="chor", query_batch=128)
    serve("serve_reduced_chor_parity", big_bucket, small, 1, 128,
          "parity_matmul_packed", "parity",
          backend=ShardedBackend(small, backend=big_bucket.backend,
                                 parity_min_batch=128, device=dev))

    # the main path ends here: read the wrappers' counts before any launch
    # made only to measure
    by_path = {"lookup": read_counts()}
    for name in ("xor_fold", "xor_fold_stream", "gather_xor",
                 "indices_from_mask", "fused_gather_fold",
                 "parity_matmul_packed"):
        if by_path["lookup"][name] <= 0:
            raise AssertionError(f"main path never launched {name}")

    # ------------------------------- CT-scale Chor in buckets of 128
    by_path["serve_chor_ct_b128"] = serve_chor_ct_b128(
        pir_ct, cfg, store, dev, rng, wrappers, ShardedBackend,
        ops.PARITY_NEVER_WINS, read_counts, reset_counts)

    # ------------------------------------------------ 7 serving a live store
    from repro_torch.data.pipeline import pir_delta_batch
    from repro_torch.db import Delta, VersionedStore

    reset_counts()
    scatter_ms = next(r["ms"] for r in rows if r["name"] == "scatter_rows")
    serve_live(pir_ct, online, store, dev, rng, pir_delta_batch, Delta,
               VersionedStore, scatter_rows, scatter_ms)
    by_path["serve_live_ct"] = read_counts()
    for name in ("gather_xor", "indices_from_mask"):
        if by_path["serve_live_ct"][name] <= 0:
            raise AssertionError(f"serve_live_ct never launched {name}")

    # ---------------------------------------------- 8 multi-index requests
    reset_counts()
    multi_batch = serve_multi(
        "serve_multi_ct", pir_ct, dataclasses.replace(online, query_batch=32),
        store, dev, rng, gather_xor, "sparse", breakdown=True,
        also=(indices_from_mask,))
    by_path["serve_multi_ct"] = read_counts()
    # its per-server split now, so that its 3.2 GB of masks do not sit
    # under the later phases' peak memory
    per_server_split(*multi_batch)
    del multi_batch
    gc.collect()
    torch.cuda.empty_cache()
    reset_counts()
    serve_multi("serve_multi_reduced", pir_ct, dataclasses.replace(
        red, query_batch=32), small, dev, rng, fused_multi_gather_fold,
        "sparse")
    by_path["serve_multi_reduced"] = read_counts()

    # --------------------- 9 the paper's other schemes, the cache, autotune
    # each on the CT store at full width: Direct Requests (p = d), Subset-
    # PIR among t = d_a + 1 of the d replicas (the smallest t with δ = 0,
    # the replicas the pipeline's latency-EMA ranking picks), Sparse-PIR
    # through an anonymity set of the config's u = 1000 users
    d = cfg.d
    for label, cfg_, expect, path, servers in (
            ("serve_direct_ct", dataclasses.replace(online, scheme="direct"),
             {}, "direct", d),
            ("serve_subset_ct", dataclasses.replace(
                online, scheme="subset", t=cfg.d_a + 1),
             {"xor_fold": cfg.d_a + 1}, "fold", cfg.d_a + 1),
            ("serve_as_sparse_ct", dataclasses.replace(
                online, scheme="as-sparse"),
             {"gather_xor": d, "indices_from_mask": d}, "sparse", d)):
        reset_counts()
        serve_scheme(label, pir_ct, cfg_, store, dev, rng, wrappers, expect,
                     path, servers)
        by_path[label] = read_counts()
    reset_counts()
    serve_cached(pir_ct, online, store, dev, rng, wrappers)
    by_path["serve_cached_sparse_ct"] = read_counts()
    reset_counts()
    autotune_ct(pir_ct, online, store, dev, rng, smi)
    by_path["autotune_ct"] = read_counts()

    # ------------------------- 9b the async front and the fleet harness
    by_path.update(async_and_fleet(
        pir_ct, online, store, red, small, rng, wrappers, sync_sparse, smi,
        read_counts, reset_counts, scatter_rows))

    # ------------------------------------ 10 the attention models: SmolLM
    by_path.update(serve_lm_smollm(dev, smi, flash_attention_fwd,
                                   read_counts, reset_counts))

    # --------------------------------------------- 11 private BERT4Rec
    by_path["serve_private_bert4rec"] = serve_private_bert4rec(
        dev, smi, flash_attention_fwd, xor_fold, read_counts, reset_counts)

    # each kernel's count comes from the first path that runs it; every
    # path's own counts ride along
    for r in rows:
        counter = r.get("counter", r["name"])
        path = next((p for p, c in by_path.items() if c[counter] > 0), None)
        if path is None:
            raise AssertionError(f"no path launched {r['name']}")
        r["launches"] = by_path[path][counter]
        r["launches_by_path"] = {p: c[counter] for p, c in by_path.items()}

    # the per-server splits of the lookup batches cut into phases
    for label, pipe, planned in deferred:
        per_server_split(label, pipe, planned)
    del deferred

    # ------------------------------------------------------------ 7 verdict
    emit({"kernels": rows})
    emit({"phase": "done", "seconds": time.perf_counter() - t_script})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
