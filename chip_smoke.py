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
its table saved, reloaded, and a foreign one dropped); then the mesh: the
CT store over a (2, 4) mesh of the card's positions (Sparse-PIR, Chor and
Direct Requests, each flush beside the unsharded pipeline's; Chor forced
to parity on ``reduced()``; a live store whose deltas rewrite only the
record blocks they touch) and SmolLM's decode with its KV cache split 4
ways by flash-decode. Between the kernel checks and the paths,
the fold is timed against the parity path across scheduler buckets at n
cut to 65 536 and at the full 10^6 (phase ``crossover``). Then the
attention models at full width: SmolLM-135M serving (prefill and
greedy decode of 4 x 4096 tokens, one 32 768-token prefill, the f32 model
on the card against the CPU) and BERT4Rec scoring 32 users whose item
histories are fetched by Sparse-PIR; then the rest of the LM family at
full width, one model at a time, each from a collected heap: gemma-2 2B
(2 x 8192 tokens; its logit softcap and local window in
``flash_attention_wgmma.cu`` at head dim 256; the f32 model on the card
against the CPU), Mistral-NeMo 12B (4 x 4096 tokens, wgmma at head dim 128),
Moonlight 16B-A3B (48 MoE layers of 64 experts, 1 x 4096 tokens, the
dropped assignments a layer; ``reduced()`` routed alike on the card and
the CPU), one layer of Kimi-K2 (384 experts, 33.8 GB) and one Moonlight
MoE block on the (2, 4) mesh of the card, its experts views of the global
weights; then the other recommenders at full table size (FM's 39·10^6
rows, DLRM-RM2's 26·10^6 x 64 words, DIEN's 10^6 items), each scored at
a batch of 512 against the CPU, its retrieval tower against 10^6
candidates, and its lookups fetched by Sparse-PIR (DLRM through the
serving pipeline and its cache), bit-equal to the plain scores;
BERT4Rec's masked-item loss; and the GCN at ogb_products' shape
(2.45·10^6 nodes, 61.9·10^6 edges; unsharded and on the (2, 4) mesh) and
at its Cora, sampled Reddit-sized and molecule shapes (FM's 39 private
ids in one Sparse-PIR plan of 1.52·10^9 draws); then training: SmolLM-135M
at full width for 20 steps of 8 x 2048 tokens (the flash kernel forward,
twice a layer with remat, the plain attention's gradient), one step of
each model on the card against the CPU, BERT4Rec and the GCN trained, and
the training launcher's resume and int8 error feedback; and last the cells
of ``launch/cells.py``: each counted on ``meta`` tensors, those whose
counted peak fits the card built at full shape and run there (pir-ct's
two on the card's mesh of 8 positions, their answers bit-equal to the
fold kernel's; SmolLM's 32 x 32 768 prefill, BERT4Rec's serve_p99, the
GCN's Cora step, and the recommenders', GCN's and gemma-2's long-decode
cells that fit), three at cut shapes on the card against the CPU, and
the dry run of five on 256 meta positions with their roofline rows.
Builds the CUDA kernels from the
ten sources in this tree (flash attention has two: bf16 at head dims 64,
128 and 256 on wgmma, everything else on the TF32 tensor cores through
mma.sync in three passes; the Sparse-PIR index compaction in front of the
gather has one, and so has the Sparse-PIR plan's mask draw), holds each
against its plain PyTorch version on the card (bit for bit for the six
GF(2) kernels, the compaction and the mask draw, PIR is exact; within the
reference's float tolerance
for flash attention, with and without the softcap and the query offset),
times them with CUDA events (the gather at batches
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

import contextlib
import dataclasses
import gc
import json
import math
import os
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
# flex_attention (the capped sets' library call) against the plain version
# in bf16: it rounds P to bf16 before P V, as SDPA does and the kernels do
# not (they carry P's rounding error in a second term), so a few bf16 ulps
# of the output; a wrong mask moves rows by far more
FLEX_TOL = {"rtol": 2e-2, "atol": 2e-2}

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
    """Largest absolute difference of two integer tensors (0 = bit-equal),
    taken 2^27 elements at a time: an int64 copy of a 12.8 GB mask would
    not fit on the card."""
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} vs {tuple(b.shape)}")
    fa, fb, step = a.reshape(-1), b.reshape(-1), 1 << 27
    return max((int((fa[i:i + step].to(torch.int64)
                     - fb[i:i + step].to(torch.int64)).abs().max().item())
                for i in range(0, fa.numel(), step)), default=0)


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
    from repro_torch.kernels.sparse_masks import sparse_masks

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

    def marks():
        # the counted kernels' launches, then sparse_masks' and the batches
        return [f_.launches for f_ in counted] + [
            sparse_masks.launches, pipe.metrics["batches"]]

    def check(out, asked, before, what):
        *grew, masks, planned = [a - b for a, b in zip(marks(), before)]
        if any(g != cfg.d for g in grew):
            raise AssertionError(
                f"{label}: {[f_.__name__ for f_ in counted]} launched {grew} "
                f"times in {what}, expected d={cfg.d}")
        # a Sparse-PIR plan draws its masks in one launch a batch
        if masks != (planned if cfg.scheme == "sparse" else 0):
            raise AssertionError(f"{label}: sparse_masks launched {masks} "
                                 f"times in {what} of {planned} batches")
        for client, lst in asked.items():
            want = np.stack([store_.record_bytes(int(i)) for i in lst])
            if out[client].shape != (len(lst), cfg.record_bytes) or \
                    not np.array_equal(out[client], want):
                raise AssertionError(f"{label}: wrong rows for {client}")
        return grew[0]

    for _ in range(flushes):
        asked = submit()
        before = marks()
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
        before = marks()
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


def traced_ops(fn):
    """Run ``fn`` once under torch.profiler: its result and the device
    operations it launched, name -> count. Measurement only."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    ops_ = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ops_[e.name] = ops_.get(e.name, 0) + 1
    return out, ops_


def check_sparse_masks(n, cfg, rng, dev):
    """sparse_masks.cu at the CT widths (n records, d servers, the plan's
    own weight law at θ): at the audit bucket of 128 with the online
    bucket of 8 riding along, each held bit for bit against the plain
    version on the card and timed against the bytes it writes."""
    from repro_torch.core import sparse
    from repro_torch.kernels.sparse_masks import (
        sparse_masks, sparse_masks_plain,
    )

    d, at = cfg.d, {}
    for b in (8, 128):
        pre = sparse.precompute_query_randomness(
            torch.Generator(device=dev).manual_seed(b), n, d, cfg.theta, b)
        q_idx = torch.from_numpy(rng.integers(0, n, size=b)).to(dev)
        at[b] = check_kernel(
            "sparse_masks", {"B": b, "n": n, "d": d, "theta": cfg.theta},
            lambda: sparse_masks(pre.w_even, pre.w_q, q_idx, pre.key, d),
            lambda: sparse_masks_plain(pre.w_even, pre.w_q, q_idx, pre.key, d),
            # the masks written and the weights read
            ((d + 1) * b * n / HBM_BYTES_PER_S * 1e3, "bytes"),
            "sparse_masks.cu",
            "src/repro/core/sparse.py:109 (no TPU kernel: jnp.argsort)",
            plain_iters=1)
        del pre, q_idx
        torch.cuda.empty_cache()
    at[128]["at_b8"] = {k: at[8][k] for k in (
        "shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}
    return at[128]


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


def attention_pairs(sq: int, sk: int, causal: bool, window,
                    q_offset: int = 0) -> int:
    """Unmasked (query, key) pairs of one attention row (keys from 0,
    queries from ``q_offset``)."""
    qpos = np.arange(sq, dtype=np.int64) + q_offset
    hi = np.minimum(qpos + 1, sk) if causal else np.full(sq, sk, np.int64)
    lo = (np.clip(qpos - window + 1, 0, sk) if window is not None
          else np.zeros(sq, np.int64))
    return int(np.maximum(hi - lo, 0).sum())


def flash_bound(bh, sq, sk, d, causal, window, dtype, peak=None, passes=1,
                q_offset=0):
    """The larger of ``passes`` × 4·d flops per unmasked pair over ``peak``
    (by default the type's: bf16 tensor cores, float32 outside them) and
    the Q/K/V/O bytes over the memory rate. A softcap's tanh a pair is not
    counted: it runs outside the tensor cores, and the bound stays the
    products'."""
    elem = 2 if dtype == torch.bfloat16 else 4
    if peak is None:
        peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S
    ops_s = (passes * 4.0 * bh
             * attention_pairs(sq, sk, causal, window, q_offset) * d / peak)
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
            {"indices_from_mask": d, "gather_xor": d, "sparse_masks": 1},
            256, read_counts, reset_counts, double_buffer=double,
            trace=double)
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
                iters=10, device_runs=0, sk=None, softcap=0.0, q_offset=0):
    """The flash kernel at one operand set (``sk`` keys, default ``sq``;
    a softcap and a query offset as the wrapper takes them) against its
    plain version (``FLASH_TOL``; bf16 operands once more cast to f32,
    held at 1e-5, so the tile loop and its skips are checked without the
    output's rounding), timed beside the plain version and one PyTorch
    call of the same function: scaled_dot_product_attention, or with a
    softcap flex_attention (``flex_library``; held to ``FLEX_TOL``
    against the plain version too, and SDPA without the cap timed beside
    it for scale); with ``device_runs``, the card's time of one call of
    each (torch.profiler, 10 calls a run) in that many runs."""
    import torch.nn.functional as F

    sk = sq if sk is None else sk
    g = torch.Generator(device=dev).manual_seed(sq + d)
    q, k, v = (torch.randn((bh, s, d), generator=g, device=dev).to(dtype)
               for s in (sq, sk, sk))
    rows = slice(0, plain_rows or bh)
    kw = {"causal": causal, "window": window}
    if softcap or q_offset:  # the capless sets call as before
        kw.update(softcap=softcap, q_offset=q_offset)

    def kernel():
        return flash_attention_fwd(q, k, v, **kw)

    def plain():
        return flash_attention_plain(q[rows], k[rows], v[rows], **kw)

    def held(q_, k_, v_, tol):
        before = dict(flash_attention_fwd.kernel_launches)
        got = flash_attention_fwd(q_, k_, v_, **kw)[rows]
        ran = [n for n, c in flash_attention_fwd.kernel_launches.items()
               if c != before[n]]
        want = flash_attention_plain(q_[rows], k_[rows], v_[rows], **kw)
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
    # the same function as one PyTorch call: causal without a window or an
    # offset as is_causal, else the mask as a boolean band
    q4, k4, v4 = (t.unsqueeze(0) for t in (q, k, v))
    band = None
    if window is not None or q_offset:
        qpos = torch.arange(sq, device=dev)[:, None] + q_offset
        kpos = torch.arange(sk, device=dev)[None, :]
        band = torch.ones((sq, sk), dtype=torch.bool, device=dev)
        if causal:
            band &= kpos <= qpos
        if window is not None:
            band &= kpos > qpos - window

    def sdpa():
        if band is not None:
            return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=band)
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)

    library, library_name, flex = sdpa, "scaled_dot_product_attention" + (
        " (band mask)" if band is not None else ""), None
    if softcap:
        library, library_name = flex_library(q4, k4, v4, causal, window,
                                             softcap, q_offset)
        got = library()[0, rows]
        want = flash_attention_plain(q[rows], k[rows], v[rows], **kw)
        flex_err = float((got.float() - want.float()).abs().max())
        if not torch.allclose(got.float(), want.float(), **FLEX_TOL):
            raise AssertionError(
                f"{library_name} {label}: differs from the plain version "
                f"(max abs err {flex_err}, {FLEX_TOL})")
        flex = {"max_abs_err": flex_err, "tolerance": FLEX_TOL}

    device = (device_runs_ms(kernel, library, kernel_name, device_runs)
              if device_runs else {})
    bound_ms, bound_by = flash_bound(bh, sq, sk, d, causal, window, dtype,
                                     q_offset=q_offset)
    # the same work's flops at the bf16 tensor-core peak, whatever the
    # operands' type: below bound_ms where the operands are f32
    bf16_peak_ms, bf16_peak_by = flash_bound(
        bh, sq, sk, d, causal, window, dtype, peak=BF16_FLOPS_PER_S,
        q_offset=q_offset)
    extra = {}
    if dtype == torch.float32:
        # what flash_attention.cu runs: three TF32 passes (3xTF32) a product
        extra["bound_at_3xtf32_ms"], extra["bound_at_3xtf32_by"] = (
            flash_bound(bh, sq, sk, d, causal, window, dtype,
                        peak=TF32_FLOPS_PER_S, passes=3, q_offset=q_offset))
    # timed in the order they always were: kernel, plain, library
    ms = time_ms(kernel, iters=iters)
    plain_ms = time_ms(plain, warmup=1, iters=2)
    library_ms = time_ms(library, iters=iters)
    if softcap:
        extra["library_against_plain"] = flex
        extra["sdpa_without_cap_ms"] = time_ms(sdpa, iters=iters)
    return {
        "label": label,
        "shape": {"bh": bh, "sq": sq, "sk": sk, "d": d,
                  "dtype": str(dtype).replace("torch.", ""), "causal": causal,
                  "window": window, "softcap": softcap, "q_offset": q_offset,
                  "plain_rows": plain_rows or bh},
        "kernel": kernel_name, "source": CSRC + FLASH_SOURCES[kernel_name],
        "max_abs_err": err, "tolerance": tol,
        "same_operands_in_f32": f32_check,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_at_bf16_peak_ms": bf16_peak_ms,
        "bound_at_bf16_peak_by": bf16_peak_by, **extra,
        "library_ms": library_ms, "library": library_name,
        **device,
    }


def flex_library(q4, k4, v4, causal, window, softcap, q_offset,
                 compile=True):
    """Capped attention as one PyTorch call: flex_attention (compiled, or
    eager with ``compile=False``; its score_mod gets the score already
    scaled by 1/sqrt(d), as the kernels' cap does) with s -> cap *
    tanh(s / cap), and the causal and window masks by absolute position
    as a block mask, applied after the cap. Returns the call and its
    name."""
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)

    def cap(score, b, h, qi, ki):
        return softcap * torch.tanh(score / softcap)

    def visible(b, h, qi, ki):
        qpos = qi + q_offset
        ok = ki <= qpos if causal else ki >= 0
        if window is not None:
            ok = ok & (ki > qpos - window)
        return ok

    mask = None
    if causal or window is not None:
        mask = create_block_mask(visible, None, None, q4.shape[2],
                                 k4.shape[2], device=q4.device)
    flex = flex_attention
    if compile:
        # inductor's and triton's caches in the checkout's ignored build/
        for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                         ("TRITON_CACHE_DIR", "triton")):
            os.environ.setdefault(var, str(ROOT / "build" / sub))
        flex = torch.compile(flex_attention, dynamic=False)
    return (lambda: flex(q4, k4, v4, score_mod=cap, block_mask=mask),
            "flex_attention (" + ("torch.compile; " if compile else "")
            + "score_mod cap*tanh(s/cap)"
            + (", block mask" if mask is not None else "") + ")")


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


# ------------------------------------------------------------------ the mesh
# every mesh position is this card: a (2, 4) mesh is 8 shards on one device
MESH_SHAPE = (2, 4)


def _mesh(dev, shape=MESH_SHAPE):
    from repro_torch.dist import make_mesh

    return make_mesh(shape, ("data", "model"), [dev])


def _rules(**over):
    from repro_torch.dist import DEFAULT_RULES

    return dict(DEFAULT_RULES, **over)


# the records over every position and the batch whole (the reference's
# xorbfly cell rules)
XORBFLY = {"records": ("data", "model"), "queries": None}


def residency_bytes(arr) -> int:
    """Bytes of a sharded array's distinct tensors."""
    return sum({sh.data.data_ptr(): sh.data.numel() * sh.data.element_size()
                for sh in arr.shards}.values())


def _flush(pipe, picks, mesh=None, rules=None):
    """Submit ``picks`` and flush (on ``mesh`` under ``rules`` when given);
    returns (answers, seconds)."""
    from repro_torch.dist import mesh_rules

    for c, i in enumerate(picks):
        if not pipe.submit(f"client-{c}", int(i)):
            raise AssertionError("budget refused a query")
    torch.cuda.synchronize()
    t = time.perf_counter()
    if mesh is None:
        out = pipe.flush()
    else:
        with mesh_rules(mesh, rules):
            out = pipe.flush()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def serve_mesh_ct(pir_ct, cfg, store, dev, rng, card, read_counts,
                  reset_counts):
    """The CT store over a (2, 4) mesh of the card: Sparse-PIR, Chor and
    Direct Requests at bucket 8 with the records over all 8 positions
    (two flushes each), and Chor under DEFAULT_RULES (queries over "data",
    records over "model"; one flush). Each mesh flush follows a flush of
    the unsharded pipeline with the same seed and picks: the records must
    be equal and the stored ones. The launch counts are set to 0 before
    each mesh flush and read after it: 8 a server for each kernel of the
    path. Returns each case's counts."""
    t_phase = time.perf_counter()
    mesh = _mesh(dev)
    d = cfg.d
    per_server = {"sparse": ("gather_xor", "indices_from_mask"),
                  "chor": ("xor_fold",), "direct": ()}
    line = {"phase": "serve_mesh_ct", "card": card, "mesh": dict(mesh.shape),
            "n": store.n, "record_bytes": cfg.record_bytes, "d": d,
            "batch": 8, "cases": {}}
    counts = {}
    for scheme, label, over, flushes in (
            ("sparse", "xorbfly", XORBFLY, 2), ("chor", "xorbfly", XORBFLY, 2),
            ("direct", "xorbfly", XORBFLY, 2), ("chor", "default", {}, 1)):
        cfg_ = dataclasses.replace(cfg, scheme=scheme)
        rules = _rules(**over)
        flat = pir_ct.make_serving_pipeline(cfg_, store=store, device=dev,
                                            seed=3)
        sharded = pir_ct.make_serving_pipeline(cfg_, store=store, device=dev,
                                               seed=3)
        torch.cuda.reset_peak_memory_stats()
        case = {"rules": {k: rules[k] for k in ("records", "queries")},
                "flush_s": [], "unsharded_flush_s": [],
                "launches_per_flush": []}
        total = None
        for _ in range(flushes):
            picks = rng.integers(0, store.n, size=8)
            want, t_flat = _flush(flat, picks)
            reset_counts()
            got, t_mesh = _flush(sharded, picks, mesh, rules)
            now = read_counts()
            total = now if total is None else {
                k: total[k] + v for k, v in now.items()}
            launched = {k: v for k, v in now.items() if v}
            case["flush_s"].append(t_mesh)
            case["unsharded_flush_s"].append(t_flat)
            case["launches_per_flush"].append(launched)
            for c, i in enumerate(picks):
                rec = store.record_bytes(int(i))
                if not (np.array_equal(got[f"client-{c}"], rec)
                        and np.array_equal(want[f"client-{c}"], rec)):
                    raise AssertionError(f"serve_mesh_ct {scheme}/{label}: "
                                         f"wrong record {int(i)}")
            expect = {k: 8 * d for k in per_server[scheme]}
            if {k: launched.get(k, 0) for k in expect} != expect or (
                    not expect and launched):
                raise AssertionError(f"serve_mesh_ct {scheme}/{label}: "
                                     f"launches {launched}, expected {expect}")
        state = sharded.backend._mesh_db[id(mesh)]
        case.update({
            "path_counts": dict(sharded.backend.path_counts),
            "shards": len(state["db"].shards), "rshards": state["rshards"],
            "n_pad": state["n_pad"],
            "residency_bytes": residency_bytes(state["db"]),
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
        })
        line["cases"][f"{scheme}_{label}"] = case
        counts[f"serve_mesh_ct_{scheme}_{label}"] = total
        del flat, sharded, state
        gc.collect()
        torch.cuda.empty_cache()
    line["seconds"] = time.perf_counter() - t_phase
    emit(line)
    return counts


def serve_mesh_parity_reduced(pir_ct, red, small, dev, rng, card,
                              read_counts, reset_counts):
    """``reduced()`` Chor at bucket 8 forced to the parity path, on and
    off the (2, 4) mesh with the same seed: equal records, and
    ``parity_matmul_packed`` launched 8 times a server on the sharded
    bit-major planes. Returns the mesh flush's counts."""
    from repro_torch.serve import ShardedBackend

    t_phase = time.perf_counter()
    mesh = _mesh(dev)
    cfg_ = dataclasses.replace(red, scheme="chor", query_batch=8)

    def pipeline():
        return pir_ct.make_serving_pipeline(
            cfg_, store=small, device=dev, seed=3,
            backend=ShardedBackend(small, backend=cfg_.backend,
                                   parity_min_batch=8, device=dev))

    flat, sharded = pipeline(), pipeline()
    picks = rng.integers(0, small.n, size=8)
    want, t_flat = _flush(flat, picks)
    reset_counts()
    got, t_mesh = _flush(sharded, picks, mesh, _rules(**XORBFLY))
    counts = read_counts()
    for c, i in enumerate(picks):
        rec = small.record_bytes(int(i))
        if not (np.array_equal(got[f"client-{c}"], want[f"client-{c}"])
                and np.array_equal(got[f"client-{c}"], rec)):
            raise AssertionError(f"serve_mesh_parity_reduced: record {i}")
    if (counts["parity_matmul_packed"] != 8 * cfg_.d
            or sharded.backend.path_counts["parity"] != cfg_.d):
        raise AssertionError(f"serve_mesh_parity_reduced: {counts}, "
                             f"{sharded.backend.path_counts}")
    planes = sharded.backend._mesh_db[id(mesh)]["planes"]
    n_loc = small.n // 8
    layouts = {(tuple(sh.data.shape), sh.data.stride()) for sh in planes.shards}
    if layouts != {((n_loc, small.record_bits), (1, n_loc))} or len(
            {sh.data.data_ptr() for sh in planes.shards}) != 8:
        raise AssertionError(f"serve_mesh_parity_reduced: planes shards are "
                             f"not bit-major blocks of their own: {layouts}")
    emit({"phase": "serve_mesh_parity_reduced", "card": card,
          "mesh": dict(mesh.shape), "n": small.n,
          "record_bytes": cfg_.record_bytes, "d": cfg_.d, "batch": 8,
          "flush_s": t_mesh, "unsharded_flush_s": t_flat,
          "planes_shard": {"shape": [n_loc, small.record_bits],
                           "stride": [1, n_loc]},
          "planes_residency_bytes": residency_bytes(planes),
          "path_counts": dict(sharded.backend.path_counts),
          "launches": {k: v for k, v in counts.items() if v},
          "seconds": time.perf_counter() - t_phase})
    return counts


def serve_mesh_live_ct(pir_ct, cfg, base, dev, rng, Delta, VersionedStore,
                       pir_delta_batch, scatter_rows, card, read_counts,
                       reset_counts):
    """A live CT store (``VersionedStore(shards=8)``) answered on the
    (2, 4) mesh while four deltas land: a 10 000-row update burst inside
    the first two of the 8 record blocks, 100 deletes in blocks 0 and 6, a
    64-record append (10^6 divides by 8, so no pad is left: the residency
    is dropped and rebuilt) and a 1 % update burst over every block. For
    each: the refresh counters equal ``touched_record_blocks``, untouched
    blocks keep their storage, ``scatter_rows`` launches once a rewritten
    block, and the answers are the snapshot's rows; the refresh (plus the
    first batch after it) is timed against ``reshard="full"`` plus the
    first batch, which rebuilds. Returns the phase's counts."""
    from repro_torch.dist import mesh_rules, touched_record_blocks
    from repro_torch.serve import SchemeRouter, ShardedBackend

    t_phase = time.perf_counter()
    mesh, rules = _mesh(dev), _rules(**XORBFLY)
    n, rb = base.n, cfg.record_bytes
    live = VersionedStore(base, shards=8)
    backend = ShardedBackend(live.snapshot(), backend=cfg.backend, device=dev)
    router = SchemeRouter(pir_ct.scheme_from_config(cfg))
    gen = torch.Generator(device=dev).manual_seed(11)

    def answer(extra=()):
        q = list(extra) + list(rng.integers(0, live.n, size=8 - len(extra)))
        tq = router.plan(gen, live.n, torch.tensor(q, device=dev))
        torch.cuda.synchronize()
        t = time.perf_counter()
        with mesh_rules(mesh, rules):
            resp = backend.answer_batch(tq, scheme=router.scheme)
        got = router.finalize(tq, resp)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        if not torch.equal(got, live.snapshot().packed[q]):
            raise AssertionError("serve_mesh_live_ct: a record is not the "
                                 "snapshot's")
        return dt

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    first_s = answer()
    block = n // 8
    (burst_all,) = pir_delta_batch(n + 64, rb, updates=10_000, seed=3, step=0)
    deltas = [
        ("update_10000_blocks_0_1", Delta.update(
            rng.choice(2 * block, 10_000, replace=False),
            rng.integers(0, 256, size=(10_000, rb), dtype=np.uint8))),
        ("delete_100_blocks_0_6", Delta.delete(np.concatenate([
            rng.choice(block, 50, replace=False),
            6 * block + rng.choice(block, 50, replace=False)]))),
        ("append_64", Delta.append(
            rng.integers(0, 256, size=(64, rb), dtype=np.uint8))),
        ("update_10000_every_block", burst_all),
    ]
    out = {}
    for label, delta in deltas:
        state = backend._mesh_db[id(mesh)]
        touched = live.touched_rows(delta, n_before=live.n)
        t = time.perf_counter()
        live.ingest(delta)
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t
        snap = live.snapshot()
        fits = snap.n <= state["n_pad"]
        want = (set(touched_record_blocks(touched, state["n_pad"],
                                          state["rshards"])) if fits else None)
        ptrs = [sh.data.data_ptr() for sh in state["db"].shards]
        before = scatter_rows.launches
        torch.cuda.synchronize()
        t = time.perf_counter()
        c = backend.swap_store(snap, touched_rows=touched, live=live)
        torch.cuda.synchronize()
        refresh_s = time.perf_counter() - t
        launched = scatter_rows.launches - before
        rec = {"rows": int(delta.count), "ingest_s": ingest_s,
               "refresh_s": refresh_s, "scatter_rows_launches": launched,
               "counters": {k: c[k] for k in (
                   "mesh_states_refreshed", "mesh_states_dropped",
                   "mesh_shards_updated", "mesh_shards_kept",
                   "store_shards_touched", "store_shards_total",
                   "plans_kept", "plans_dropped")}}
        if fits:
            rec["touched_blocks"] = sorted(want)
            now = [sh.data.data_ptr() for sh in
                   backend._mesh_db[id(mesh)]["db"].shards]
            kept_same = [a == b for a, b in zip(now, ptrs)]
            if (c["mesh_shards_updated"] != len(want)
                    or c["mesh_shards_kept"] != 8 - len(want)
                    or c["mesh_states_refreshed"] != 1
                    or launched != len(want)
                    or kept_same != [i not in want for i in range(8)]):
                raise AssertionError(f"serve_mesh_live_ct {label}: {rec}, "
                                     f"identity {kept_same}")
        elif c["mesh_states_dropped"] != 1 or launched:
            raise AssertionError(f"serve_mesh_live_ct {label}: {rec}")
        extra = ([int(delta.indices[0])] if delta.kind != "append"
                 else [n + 7])
        rec["batch_after_refresh_s"] = answer(extra)
        rec["rebuilt"] = not fits
        t = time.perf_counter()
        backend.swap_store(snap, reshard="full")
        rec["full_reshard_s"] = time.perf_counter() - t
        # the re-shard the next batch on the mesh does, timed alone
        torch.cuda.synchronize()
        t = time.perf_counter()
        with mesh_rules(mesh, rules):
            backend._mesh_state()
        torch.cuda.synchronize()
        rec["rebuild_s"] = time.perf_counter() - t
        rec["batch_after_full_s"] = answer(extra)
        out[label] = rec
    counts = read_counts()
    for k in ("scatter_rows", "gather_xor", "indices_from_mask"):
        if counts[k] <= 0:
            raise AssertionError(f"serve_mesh_live_ct never launched {k}")
    emit({"phase": "serve_mesh_live_ct", "card": card,
          "mesh": dict(mesh.shape), "scheme": cfg.scheme, "n": n,
          "n_after": live.n, "record_bytes": rb, "d": cfg.d, "batch": 8,
          "shards": live.shards, "first_batch_s": first_s, "deltas": out,
          "mesh_metrics": dict(backend.mesh_metrics),
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "launches": {k: v for k, v in counts.items() if v},
          "seconds": time.perf_counter() - t_phase})
    del backend, live
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def decode_mesh_smollm(dev, card, read_counts, reset_counts):
    """Full-width SmolLM-135M (bf16, random weights from seed 0): the
    4 x 4096-token prefill, then 32 greedy decode steps under
    DEFAULT_RULES on a (1, 4) mesh of the card, so the KV cache's
    sequence (4128) is split 4 ways by flash-decode, against the same 32
    steps unsharded from a copy of the cache. Then the f32 model at 256 +
    32 tokens: logits within 1e-3 of the unsharded decode and the same
    greedy tokens. Returns the path's counts (prefill + mesh decode)."""
    from repro_torch.configs import get_arch
    from repro_torch.data import lm_batch
    from repro_torch.dist import DEFAULT_RULES, mesh_rules
    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    cfg = get_arch("smollm-135m").CONFIG
    mesh = _mesh(dev, (1, 4))
    model = T.init_lm(torch.Generator(device=dev).manual_seed(0), cfg,
                      device=dev)

    def decode(model_, cfg_, cache, tok, start, steps, on_mesh):
        toks, logits_all = [tok], []
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(steps):
            if on_mesh:
                with mesh_rules(mesh, DEFAULT_RULES):
                    logits, cache = T.decode_step(model_, cfg_, cache, tok,
                                                  start + i)
            else:
                logits, cache = T.decode_step(model_, cfg_, cache, tok,
                                              start + i)
            tok = logits.argmax(-1, keepdim=True)
            toks.append(tok)
            logits_all.append(logits)
        torch.cuda.synchronize()
        return (torch.cat(toks, 1), torch.stack(logits_all),
                time.perf_counter() - t)

    batch, prompt, new = 4, 4096, 32
    tokens = torch.from_numpy(
        lm_batch(cfg, batch, prompt, seed=0, step=0)["tokens"]).to(dev)
    reset_counts()
    logits, cache = T.prefill(model, cfg, tokens, prompt + new)
    copy = T.KVCache(k=cache.k.clone(), v=cache.v.clone())
    tok = logits.argmax(-1, keepdim=True)
    mesh_toks, mesh_logits, mesh_s = decode(model, cfg, cache, tok, prompt,
                                            new, True)
    counts = read_counts()
    flat_toks, _, flat_s = decode(model, cfg, copy, tok, prompt, new, False)
    if not (torch.isfinite(mesh_logits).all() and mesh_toks.min() >= 0
            and mesh_toks.max() < cfg.vocab):
        raise AssertionError("decode_mesh_smollm: bad logits or tokens")
    del cache, copy, logits, mesh_logits

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    m32 = T.TransformerLM(model.tree(), cfg32).float()
    tokens = torch.from_numpy(
        lm_batch(cfg, 1, 256, seed=0, step=2)["tokens"]).to(dev)
    logits, cache = T.prefill(m32, cfg32, tokens, 256 + new)
    copy = T.KVCache(k=cache.k.clone(), v=cache.v.clone())
    tok = logits.argmax(-1, keepdim=True)
    toks32, logits32, _ = decode(m32, cfg32, cache, tok, 256, new, True)
    want_toks, want32, _ = decode(m32, cfg32, copy, tok, 256, new, False)
    err = float((logits32 - want32).abs().max())
    if not (torch.allclose(logits32, want32, rtol=1e-3, atol=1e-3)
            and torch.equal(toks32, want_toks)):
        raise AssertionError(f"decode_mesh_smollm f32: max abs err {err}, "
                             "tokens equal "
                             f"{bool(torch.equal(toks32, want_toks))}")
    emit({"phase": "decode_mesh_smollm", "card": card, "config": cfg.name,
          "mesh": dict(mesh.shape), "rules": {"kv_seq": "model",
                                              "batch": "data"},
          "requests": batch, "prompt": prompt, "new_tokens": new,
          "cache_len": prompt + new, "chunk": (prompt + new) // 4,
          "decode_ms_per_token": mesh_s / new * 1e3,
          "unsharded_decode_ms_per_token": flat_s / new * 1e3,
          "bf16_tokens_equal_unsharded": float(
              (mesh_toks == flat_toks).float().mean()),
          "f32_check": {"prompt": 256, "new_tokens": new,
                        "max_abs_err": err,
                        "tolerance": {"rtol": 1e-3, "atol": 1e-3},
                        "tokens_equal": True},
          "launches": {k: v for k, v in counts.items() if v},
          "seconds": time.perf_counter() - t_phase})
    del model, m32, cache, copy
    torch.cuda.empty_cache()
    return counts


# ------------------------------------------------- the rest of the LM family
LM_GROUPS = {"flash": ["flash_fwd_kernel", "flash_wgmma_kernel"],
             "matmul": ["gemm", "Gemm", "nvjet", "cutlass", "xmma"]}


def lm_phase_start():
    """A large model phase starts from a collected heap: what earlier
    phases left to the collector would sit under its peak. Returns the
    memory allocated at its start."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def lm_phase_end():
    gc.collect()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def watch_attention():
    """Within the block: the (window, softcap, q_offset) of each flash
    call that ``gqa_attention`` makes, and the calls of the plain
    attention paths (``_attn_core``, ``flash_attention_plain``), which a
    model on the card must never make."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import layers as L

    seen = {"flash_calls": [], "plain_calls": 0}
    real = (L.flash_attention_fwd, FA.flash_attention_plain, L._attn_core)

    def fwd(*args, **kw):
        seen["flash_calls"].append(
            [kw.get("window"), kw.get("softcap"), kw.get("q_offset")])
        return real[0](*args, **kw)

    def plain(*args, **kw):
        seen["plain_calls"] += 1
        return real[1](*args, **kw)

    def core(*args, **kw):
        seen["plain_calls"] += 1
        return real[2](*args, **kw)

    L.flash_attention_fwd, FA.flash_attention_plain, L._attn_core = (
        fwd, plain, core)
    try:
        yield seen
    finally:
        L.flash_attention_fwd, FA.flash_attention_plain, L._attn_core = real


@contextlib.contextmanager
def record_routing():
    """Within the block: each MoE block's routing (``moe.Routing``: the
    top-k expert ids, which assignments are kept), in call order; on a
    mesh, one a position."""
    from repro_torch.models import moe as M

    seen = []
    real = M.moe_route

    def route(*args, **kw):
        r = real(*args, **kw)
        seen.append(r)
        return r

    M.moe_route = route
    try:
        yield seen
    finally:
        M.moe_route = real


def _first_layers(tree, n):
    if isinstance(tree, torch.Tensor):
        return tree[:n]
    return {k: _first_layers(v, n) for k, v in tree.items()}


def run_lm(label, model, cfg, tokens, new, flash, kernel, read_counts,
           reset_counts):
    """``prefill`` then ``new`` greedy ``decode_step``s of ``model``,
    its counts set to 0 before and read after, every prefill layer held
    to one launch of ``kernel`` and no plain attention. Returns the
    phase's measurements, the path's counts, the cache and the last
    tokens."""
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T

    b, prompt = tokens.shape
    reset_counts()
    torch.cuda.synchronize()
    with watch_attention() as seen, record_routing() as routes:
        t = time.perf_counter()
        logits, cache = T.prefill(model, cfg, tokens, prompt + new)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t
        prefill_counts = read_counts()
        prefill_blocks = len(routes)
        tok = logits.argmax(-1, keepdim=True)
        out = [tok]
        t = time.perf_counter()
        for i in range(new):
            logits, cache = T.decode_step(model, cfg, cache, tok, prompt + i)
            tok = logits.argmax(-1, keepdim=True)
            out.append(tok)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t
    counts = read_counts()
    by_kernel = {n: prefill_counts[n] for n in FLASH_SOURCES}
    want = {n: cfg.n_layers * (n == kernel) for n in FLASH_SOURCES}
    if by_kernel != want or counts["flash_attention_fwd"] != cfg.n_layers:
        raise AssertionError(f"{label}: flash launches {by_kernel} in the "
                             f"prefill, {counts['flash_attention_fwd']} in "
                             f"all, expected {want}")
    if seen["plain_calls"]:
        raise AssertionError(f"{label}: {seen['plain_calls']} calls of a "
                             "plain attention path on the card")
    generated = torch.cat(out, dim=1)
    if not (torch.isfinite(logits).all() and generated.min() >= 0
            and generated.max() < cfg.vocab
            and generated.shape == (b, new + 1)):
        raise AssertionError(f"{label}: bad logits or tokens")
    line = {
        "config": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "heads": [cfg.n_heads, cfg.n_kv_heads], "head_dim": cfg.head_dim,
        "d_ff": cfg.d_ff, "vocab": cfg.vocab, "dtype": cfg.dtype,
        "requests": b, "prompt": prompt, "new_tokens": new,
        "prefill_s": prefill_s,
        "prefill_tokens_per_s": b * prompt / prefill_s,
        "decode_ms_per_token": decode_s / new * 1e3,
        "decode_tokens_per_s": b * new / decode_s,
        "flash_kernel_launches_per_prefill": by_kernel,
        "flash_calls_per_prefill": seen["flash_calls"][:cfg.n_layers],
        "plain_attention_calls": seen["plain_calls"],
        "launches": {k: v for k, v in counts.items() if v},
    }
    if cfg.moe:
        per_layer = torch.stack([torch.stack([r.keep.sum(), (~r.keep).sum()])
                                 for r in routes]).tolist()
        line["moe"] = {
            "experts": cfg.n_experts, "top_k": cfg.top_k,
            "capacity_prefill": M.moe_capacity(b * prompt, cfg.n_experts,
                                               cfg.top_k,
                                               cfg.capacity_factor),
            "capacity_decode": M.moe_capacity(b, cfg.n_experts, cfg.top_k,
                                              cfg.capacity_factor),
            "kept_dropped_per_prefill_layer": per_layer[:prefill_blocks],
            "dropped_in_decode": sum(d for _, d in per_layer[prefill_blocks:]),
        }
    return line, counts, cache, tok


def lm_split(model, cfg, tokens, cache, tok, max_len):
    """Where the card's time goes: one more prefill, and one decode step
    that rewrites the last position (after the path's counts are read)."""
    from repro_torch.models import transformer as T

    return {
        "split_prefill": device_split(
            lambda: T.prefill(model, cfg, tokens, max_len), LM_GROUPS),
        "split_decode_step": device_split(
            lambda: T.decode_step(model, cfg, cache, tok, max_len - 1),
            LM_GROUPS),
    }


def card_vs_cpu(label, model, cfg, tokens, kernel, read_counts,
                reset_counts, routing=False):
    """The f32 model on the card (the flash kernel) against the same
    weights on the CPU (the plain path): logits within rtol = atol = 1e-3,
    argmax equal, and with ``routing`` the same experts in every MoE
    block."""
    from repro_torch.models import transformer as T

    host = T.TransformerLM(model.tree(), cfg).to("cpu")
    reset_counts()
    with record_routing() as card_routes:
        got, _ = T.prefill(model, cfg, tokens, tokens.shape[1])
    torch.cuda.synchronize()
    counts = read_counts()
    if counts[kernel] != cfg.n_layers:
        raise AssertionError(f"{label}: the f32 prefill's flash launches are "
                             f"{counts}, expected {cfg.n_layers} on {kernel}")
    with record_routing() as host_routes:
        want, _ = T.prefill(host, cfg, tokens, tokens.shape[1])
    got = got.cpu()
    err = float((got - want).abs().max())
    same_argmax = bool(torch.equal(got.argmax(-1), want.argmax(-1)))
    same_routes = (len(card_routes) == len(host_routes) and all(
        torch.equal(a.top_e.cpu(), b.top_e)
        for a, b in zip(card_routes, host_routes)))
    if (not torch.allclose(got, want, rtol=1e-3, atol=1e-3)
            or not same_argmax or (routing and not same_routes)):
        raise AssertionError(f"{label}: card vs CPU max abs err {err}, "
                             f"argmax equal {same_argmax}, routing equal "
                             f"{same_routes}")
    top2 = torch.topk(want, 2, dim=-1).values
    out = {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "tokens": list(tokens.shape), "max_abs_err": err,
           "tolerance": {"rtol": 1e-3, "atol": 1e-3},
           "argmax_equal": same_argmax,
           "top2_margin": float((top2[:, 0] - top2[:, 1]).min()),
           "flash_kernel_launches": {n: counts[n] for n in FLASH_SOURCES}}
    if routing:
        out["routing_equal"] = same_routes
        out["moe_blocks"] = len(card_routes)
    del host
    return out


def serve_lm_gemma2(dev, card, flash, read_counts, reset_counts):
    """Full-width gemma-2 2B (26 layers, bf16, random weights from seed 0):
    2 requests of 8192 tokens and 32 greedy tokens each; every prefill
    layer on ``flash_attention_wgmma.cu`` (head dim 256) with cap 50, the
    even layers with the 4096-token window; no prefill launch of
    ``flash_attention.cu``. Then the f32 model, card against
    CPU: full width cut to 2 layers (one local, one global) at 1 x 512
    tokens, and ``reduced()`` (window 8, so it masks; the caps) at 1 x 64.
    Returns the path's counts."""
    from repro_torch.configs import get_arch
    from repro_torch.data import lm_batch
    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    start = lm_phase_start()
    arch = get_arch("gemma2-2b")
    cfg = arch.CONFIG
    model = T.init_lm(torch.Generator(device=dev).manual_seed(0), cfg,
                      device=dev)
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated() - start
    init_s = time.perf_counter() - t_phase
    batch, prompt, new = 2, 8192, 32
    tokens = torch.from_numpy(
        lm_batch(cfg, batch, prompt, seed=0, step=0)["tokens"]).to(dev)
    line, counts, cache, tok = run_lm(
        "serve_lm_gemma2", model, cfg, tokens, new, flash,
        "flash_wgmma_kernel", read_counts, reset_counts)
    windowed = sum(1 for w, cap, _ in line["flash_calls_per_prefill"]
                   if w < prompt)
    capped = sum(1 for _, cap, _ in line["flash_calls_per_prefill"]
                 if cap == cfg.attn_softcap)
    if windowed != cfg.n_layers // 2 or capped != cfg.n_layers:
        raise AssertionError(f"serve_lm_gemma2: {windowed} windowed and "
                             f"{capped} capped flash calls a prefill")
    peak = torch.cuda.max_memory_allocated()
    line.update(lm_split(model, cfg, tokens, cache, tok, prompt + new))
    del cache
    line.update({
        "phase": "serve_lm_gemma2", "card": card, "init_s": init_s,
        "memory_at_start": start, "weights_bytes": weights,
        "max_memory_allocated": peak,
        "windowed_flash_calls": windowed, "capped_flash_calls": capped,
    })

    # the f32 checks: the first two layers at full width, then reduced()
    tree = model.tree()
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    two = T.TransformerLM({"embed": tree["embed"],
                           "layers": _first_layers(tree["layers"], 2),
                           "final_norm": tree["final_norm"]}, cfg2).float()
    del model, tree
    lm_phase_end()
    line["f32_card_vs_cpu_full_width_2_layers"] = card_vs_cpu(
        "serve_lm_gemma2 f32 (2 layers)", two, cfg2,
        lm_batch(cfg2, 1, 512, seed=0, step=2)["tokens"], "flash_fwd_kernel",
        read_counts, reset_counts)
    del two
    red = arch.reduced()
    small = T.init_lm(torch.Generator(device=dev).manual_seed(1), red,
                      device=dev)
    line["f32_card_vs_cpu_reduced"] = card_vs_cpu(
        "serve_lm_gemma2 f32 (reduced)", small, red,
        lm_batch(red, 1, 64, seed=0, step=3)["tokens"], "flash_fwd_kernel",
        read_counts, reset_counts)
    line["seconds"] = time.perf_counter() - t_phase
    emit(line)
    del small
    lm_phase_end()
    # the path's flash_wgmma_kernel launches split by the call's window
    # (one launch a call, checked in run_lm): sets (g) and (g') read these
    return dict(counts, **{
        "flash_wgmma_kernel:global": cfg.n_layers - windowed,
        f"flash_wgmma_kernel:window_{cfg.window}": windowed})


def serve_lm_mistral_nemo(dev, card, flash, read_counts, reset_counts):
    """Full-width Mistral-NeMo 12B (40 layers, d 5120, 32/8 heads, head dim
    128, bf16, 23.2 GB, random weights from seed 0): 4 requests of 4096
    tokens (``train_4k``'s length) and 16 greedy tokens each; every
    prefill layer on the wgmma kernel at d 128. Returns the path's
    counts."""
    from repro_torch.configs import get_arch
    from repro_torch.data import lm_batch
    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    start = lm_phase_start()
    cfg = get_arch("mistral-nemo-12b").CONFIG
    model = T.init_lm(torch.Generator(device=dev).manual_seed(0), cfg,
                      device=dev)
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated() - start
    init_s = time.perf_counter() - t_phase
    batch, prompt, new = 4, 4096, 16
    tokens = torch.from_numpy(
        lm_batch(cfg, batch, prompt, seed=0, step=0)["tokens"]).to(dev)
    line, counts, cache, tok = run_lm(
        "serve_lm_mistral_nemo", model, cfg, tokens, new, flash,
        "flash_wgmma_kernel", read_counts, reset_counts)
    peak = torch.cuda.max_memory_allocated()
    line.update(lm_split(model, cfg, tokens, cache, tok, prompt + new))
    line.update({"phase": "serve_lm_mistral_nemo", "card": card,
                 "init_s": init_s, "memory_at_start": start,
                 "weights_bytes": weights, "max_memory_allocated": peak,
                 "seconds": time.perf_counter() - t_phase})
    emit(line)
    del model, cache
    lm_phase_end()
    return counts


def serve_lm_moonshot(dev, card, flash, read_counts, reset_counts):
    """Full-width Moonlight 16B-A3B (48 layers, 64 experts, top 6, expert
    d_ff 1408, bf16, 55.4 GB, random weights from seed 0): 1 request of
    4096 tokens and 16 greedy tokens (capacity 480 a prefill, 8 a decode
    step; the kept and dropped assignments of every layer reported);
    every prefill layer on the wgmma kernel at d 128. Then ``reduced()``
    in f32, card against CPU: the same experts in every block, logits
    within 1e-3. Returns the path's counts."""
    from repro_torch.configs import get_arch
    from repro_torch.data import lm_batch
    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    start = lm_phase_start()
    arch = get_arch("moonshot-v1-16b-a3b")
    cfg = arch.CONFIG
    model = T.init_lm(torch.Generator(device=dev).manual_seed(0), cfg,
                      device=dev)
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated() - start
    init_s = time.perf_counter() - t_phase
    batch, prompt, new = 1, 4096, 16
    tokens = torch.from_numpy(
        lm_batch(cfg, batch, prompt, seed=0, step=0)["tokens"]).to(dev)
    line, counts, cache, tok = run_lm(
        "serve_lm_moonshot", model, cfg, tokens, new, flash,
        "flash_wgmma_kernel", read_counts, reset_counts)
    if line["moe"]["capacity_prefill"] != 480:
        raise AssertionError(f"serve_lm_moonshot: capacity {line['moe']}")
    peak = torch.cuda.max_memory_allocated()
    line.update(lm_split(model, cfg, tokens, cache, tok, prompt + new))
    del model, cache
    lm_phase_end()
    red = arch.reduced()
    small = T.init_lm(torch.Generator(device=dev).manual_seed(1), red,
                      device=dev)
    line["f32_card_vs_cpu_reduced"] = card_vs_cpu(
        "serve_lm_moonshot f32 (reduced)", small, red,
        lm_batch(red, 2, 64, seed=0, step=3)["tokens"], "flash_fwd_kernel",
        read_counts, reset_counts, routing=True)
    line.update({"phase": "serve_lm_moonshot", "card": card,
                 "init_s": init_s, "memory_at_start": start,
                 "weights_bytes": weights, "max_memory_allocated": peak,
                 "seconds": time.perf_counter() - t_phase})
    emit(line)
    del small
    lm_phase_end()
    return counts


def serve_lm_kimi_layer(dev, card, flash, read_counts, reset_counts):
    """Kimi-K2 at full width with its depth cut from 61 layers to 1 (the
    whole model is 2.08 TB; one layer's 384 experts are 33.8 GB in bf16):
    1 request of 4096 tokens (capacity 112) and 8 greedy tokens; its one
    prefill layer on the wgmma kernel at d 128 (64 query heads over 8 kv
    heads). Returns the path's counts."""
    from repro_torch.configs import get_arch
    from repro_torch.data import lm_batch
    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    start = lm_phase_start()
    cfg = dataclasses.replace(get_arch("kimi-k2-1t-a32b").CONFIG, n_layers=1)
    model = T.init_lm(torch.Generator(device=dev).manual_seed(0), cfg,
                      device=dev)
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated() - start
    init_s = time.perf_counter() - t_phase
    batch, prompt, new = 1, 4096, 8
    tokens = torch.from_numpy(
        lm_batch(cfg, batch, prompt, seed=0, step=0)["tokens"]).to(dev)
    line, counts, cache, tok = run_lm(
        "serve_lm_kimi_layer", model, cfg, tokens, new, flash,
        "flash_wgmma_kernel", read_counts, reset_counts)
    if line["moe"]["capacity_prefill"] != 112:
        raise AssertionError(f"serve_lm_kimi_layer: capacity {line['moe']}")
    peak = torch.cuda.max_memory_allocated()
    line.update(lm_split(model, cfg, tokens, cache, tok, prompt + new))
    line.update({"phase": "serve_lm_kimi_layer", "card": card,
                 "depth_cut": [61, 1], "init_s": init_s,
                 "memory_at_start": start, "weights_bytes": weights,
                 "max_memory_allocated": peak,
                 "seconds": time.perf_counter() - t_phase})
    emit(line)
    del model, cache
    lm_phase_end()
    return counts


# the mesh branch against the unsharded block, in bf16: each output row is
# a sum of top_k expert rows of order 1 weighted by probabilities; the mesh
# adds each position's partial sum (its experts' slots) and then the four
# partials, the unsharded block the slots in order, so the two differ by a
# few bf16 roundings (2^-9 relative each) of order-1 partial sums
MOE_MESH_TOL = {"rtol": 2e-2, "atol": 2e-2}


def moe_mesh_moonshot(dev, card, read_counts, reset_counts):
    """One Moonlight MoE block at full width (64 experts of 2048 x 1408,
    top 6, bf16, weights from seed 0) on the (2, 4) mesh of the card under
    DEFAULT_RULES: 2 x 4096 tokens, a batch block of 4096 over "data", 16
    experts a position over "model", each position's experts views of the
    global weights. Against the unsharded block on the same tokens, on the
    rows that neither drops (the mesh's capacity comes from its 4096 local
    tokens, the unsharded block's from 8192). Returns the path's counts."""
    from repro_torch.configs import get_arch
    from repro_torch.dist import DEFAULT_RULES, mesh_rules
    from repro_torch.models import moe as M

    t_phase = time.perf_counter()
    start = lm_phase_start()
    cfg = get_arch("moonshot-v1-16b-a3b").CONFIG
    mesh = _mesh(dev)
    params = M.moe_init(torch.Generator(device=dev).manual_seed(0),
                        cfg.d_model, cfg.d_ff, cfg.n_experts, torch.bfloat16,
                        device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((2, 4096, cfg.d_model), generator=g,
                    device=dev).to(torch.bfloat16)
    kw = {"n_experts": cfg.n_experts, "top_k": cfg.top_k,
          "capacity_factor": cfg.capacity_factor}
    e_loc = cfg.n_experts // mesh.shape["model"]
    views = True
    for block in M.expert_blocks(params, mesh, ("model",), e_loc):
        for name, view in zip(("w_gate", "w_in", "w_out"), block):
            whole = params[name]
            lo = whole.data_ptr()
            views &= lo <= view.data_ptr() < lo + whole.nbytes
    if not views:
        raise AssertionError("moe_mesh_moonshot: an expert block is a copy")
    reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    with mesh_rules(mesh, DEFAULT_RULES), record_routing() as routes:
        y, aux = M.moe_apply(params, x, **kw)
    torch.cuda.synchronize()
    mesh_s = time.perf_counter() - t
    counts = read_counts()
    t = time.perf_counter()
    flat, flat_aux = M.moe_apply(params, x, **kw)
    torch.cuda.synchronize()
    flat_s = time.perf_counter() - t
    x2 = x.reshape(-1, cfg.d_model)
    cap_mesh = M.moe_capacity(4096, cfg.n_experts, cfg.top_k,
                              cfg.capacity_factor)
    cap_flat = M.moe_capacity(8192, cfg.n_experts, cfg.top_k,
                              cfg.capacity_factor)
    kept_flat = M.moe_route(x2, params["router"], top_k=cfg.top_k,
                            capacity=cap_flat).keep.all(dim=1)
    kept_mesh = torch.cat([
        M.moe_route(x2[b * 4096:(b + 1) * 4096], params["router"],
                    top_k=cfg.top_k, capacity=cap_mesh).keep.all(dim=1)
        for b in range(2)])
    rows = kept_flat & kept_mesh
    got, want = y.reshape(-1, cfg.d_model)[rows], flat.reshape(
        -1, cfg.d_model)[rows]
    err = float((got.float() - want.float()).abs().max())
    if not (torch.isfinite(y).all() and rows.sum() > 0
            and torch.allclose(got.float(), want.float(), **MOE_MESH_TOL)):
        raise AssertionError(f"moe_mesh_moonshot: max abs err {err} on "
                             f"{int(rows.sum())} rows ({MOE_MESH_TOL})")
    # the positions of a batch block route alike: one count a block
    per_block = [[int(r.keep.sum()), int((~r.keep).sum())]
                 for r in routes[::mesh.shape["model"]]]

    def on_mesh():
        with mesh_rules(mesh, DEFAULT_RULES):
            return M.moe_apply(params, x, **kw)

    splits = {"split_mesh": device_split(on_mesh, LM_GROUPS),
              "split_unsharded": device_split(
                  lambda: M.moe_apply(params, x, **kw), LM_GROUPS)}
    emit({"phase": "moe_mesh_moonshot", "card": card, "config": cfg.name,
          "mesh": dict(mesh.shape), "rules": {"experts": "model",
                                              "batch": "data"},
          "tokens": 2 * 4096, "experts_per_position": e_loc,
          "capacity_mesh": cap_mesh, "capacity_unsharded": cap_flat,
          "expert_weights_are_views": views,
          "rows_compared": int(rows.sum()), "max_abs_err": err,
          "tolerance": MOE_MESH_TOL,
          "aux": float(aux), "aux_unsharded": float(flat_aux),
          "kept_dropped_per_batch_block": per_block,
          "mesh_s": mesh_s, "unsharded_s": flat_s, **splits,
          "memory_at_start": start,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "launches": {k: v for k, v in counts.items() if v},
          "seconds": time.perf_counter() - t_phase})
    del params, x, y, flat
    lm_phase_end()
    return counts


# ----------------------------------------- the other recommenders, the GCN
# device ms of the recommender and GCN phases, by kernel
MODEL_SPLIT = {
    "xor_fold": ["xor_fold"],
    "gather_xor": ["gather_prep", "gather_xor"],
    "indices_from_mask": ["ifm_"],
    "flash_fwd_kernel": ["flash_fwd_kernel"],
    "sort": ["sort", "Sort", "radix"],
    "segment_reduce": ["segment_reduce"],
    "matmul": ["gemm", "Gemm", "nvjet", "cutlass", "xmma"],
    "gather_index": ["index", "gather", "Index"],
}
RECSYS_TOL = {"rtol": 1e-4, "atol": 1e-4}
RECSYS_BATCH = 512          # serve_p99's batch


def timed_s(fn):
    """``fn()`` once as a warm-up, then once on the host clock ending in
    ``torch.cuda.synchronize()``: (its result, seconds)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def close_to_cpu(label, got, want, tol=RECSYS_TOL):
    """The card's ``got`` against the CPU's ``want`` within ``tol``:
    finite, the same shape; returns the largest absolute error."""
    got = got.detach().cpu()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label}: {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}, or not finite")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not torch.allclose(got, want, **tol):
        raise AssertionError(f"{label}: card vs CPU max abs err {err}")
    return err


def bit_equal(label, private, plain):
    """Private scores against plain ones, bit for bit."""
    if private.shape != plain.shape or not torch.equal(
            private.view(torch.int32), plain.view(torch.int32)):
        raise AssertionError(f"{label}: private scores differ from the "
                             "plain-lookup scores")
    return True


def _rows(batch, lo, hi):
    return {k: v[lo:hi] for k, v in batch.items()}


def private_lookups(pes, gen, counted, log):
    """A ``lookup_fn`` that fetches every id through the
    ``PrivateEmbedding`` of its table (``pes``: data_ptr -> embedding), all
    of a call's ids in one staged retrieve (FM's 39 ids over 39·10^6 rows:
    a plan of 1.52·10^9 draws, past what one ``torch.multinomial`` call
    takes on the card, drawn in chunks by ``sparse._categorical``),
    logging each call's launches of the wrappers in ``counted``."""

    def lookup(table, ids):
        before = {k: f_.launches for k, f_ in counted.items()}
        forms = dict(counted["xor_fold"].kernel_launches)
        pe = pes[table.data_ptr()]
        rows = pe.lookup(gen, ids.reshape(-1)).reshape(*ids.shape, pe.dim)
        torch.cuda.synchronize()
        log.append({"ids": list(ids.shape),
                    "plan_draws": ids.numel() * pe.vocab,
                    **{k: f_.launches - before[k]
                       for k, f_ in counted.items()},
                    **{f"xor_fold_{k}": c - forms[k] for k, c in
                       counted["xor_fold"].kernel_launches.items()}})
        return rows

    return lookup


def pipeline_lookups(pipe, log, prefix="user"):
    """A ``lookup_fn`` through the serving pipeline: each example's ids
    (one row of ``ids``) as one ``submit_many`` request, flushed alone;
    the record bytes come back as f32 rows, bit for bit."""

    def lookup(table, ids):
        rows = []
        for j, row in enumerate(ids.tolist()):
            client = f"{prefix}{j}"
            if not pipe.submit_many(client, row):
                raise AssertionError("the budget refused a request")
            hits = pipe.metrics["cache_hits"]
            before = gather_launches()
            torch.cuda.synchronize()
            t = time.perf_counter()
            rows.append(pipe.flush()[client])
            torch.cuda.synchronize()
            log.append({"client": client, "k": len(row),
                        "flush_s": time.perf_counter() - t,
                        "cache_hits": pipe.metrics["cache_hits"] - hits,
                        "launches": {k: c - before[k] for k, c in
                                     gather_launches().items()}})
        raw = np.ascontiguousarray(np.stack(rows))    # [B, k, 4·dim] bytes
        return torch.from_numpy(raw.view(np.float32)).reshape(
            *ids.shape, table.shape[1]).to(table.device)

    return lookup


def gather_launches():
    from repro_torch.kernels.gather_xor import gather_xor, indices_from_mask
    from repro_torch.kernels.xor_fold import xor_fold

    return {"indices_from_mask": indices_from_mask.launches,
            "gather_xor": gather_xor.launches, "xor_fold": xor_fold.launches}


def serve_recsys(arch_id, dev, card, read_counts, reset_counts):
    """One recommender at its full config (random weights from seed 0,
    every table at full size on the card): (a) plain scores at
    ``serve_p99``'s batch of 512; (b) the same weights and batch on the
    CPU; (c) the retrieval tower at ``retrieval_cand``'s shape (one
    example against 10^6 candidates) and at the batch of 512; (d) private
    lookups by Sparse-PIR at the config's d, d_a and θ, bit-equal to the
    plain scores: DLRM through the serving pipeline (each example's ids
    one ``submit_many``, flushed alone, then the same requests from the
    cache), FM (both tables) and DIEN (the item table) through
    ``PrivateEmbedding``. Returns the private path's launch counts."""
    from repro_torch.configs import get_arch
    from repro_torch.core import PrivateEmbedding, SparseScheme
    from repro_torch.core.accounting import PrivacyBudget
    from repro_torch.data import recsys_batch
    from repro_torch.db.store import RecordStore
    from repro_torch.kernels.xor_fold import xor_fold
    from repro_torch.models import recsys as R
    from repro_torch.serve import BatchScheduler, QueryCache, ServingPipeline

    label = f"serve_{arch_id.replace('-', '_')}"
    t_phase = time.perf_counter()
    start = lm_phase_start()
    arch = get_arch(arch_id)
    cfg = arch.CONFIG
    init, score = {"fm": (R.fm_init, R.fm_score),
                   "dlrm": (R.dlrm_init, R.dlrm_score),
                   "dien": (R.dien_init, R.dien_score)}[cfg.model]
    model = init(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t_phase
    tree = model.tree()
    tables = {k: list(tree[k].shape) for k in ("embed", "linear")
              if k in tree}
    line = {"phase": label, "card": card, "config": cfg.name,
            "model": cfg.model, "embed_dim": cfg.embed_dim,
            "n_sparse": cfg.n_sparse, "n_dense": cfg.n_dense,
            "vocab_per_field": cfg.vocab_per_field, "seq_len": cfg.seq_len,
            "gru_dim": cfg.gru_dim, "bot_mlp": list(cfg.bot_mlp),
            "top_mlp": list(cfg.top_mlp), "mlp_dims": list(cfg.mlp_dims),
            "tables": tables,
            "table_bytes": sum(tree[k].numel() * 4 for k in tables),
            "weights_bytes": torch.cuda.memory_allocated() - start,
            "init_s": init_s, "batch": RECSYS_BATCH}

    # (a) plain scores, (b) the CPU
    batch = recsys_batch(cfg, RECSYS_BATCH, seed=0, step=0)
    reset_counts()
    plain, line["plain_s"] = timed_s(lambda: score(model, cfg, batch))
    line["plain_launches"] = {k: c for k, c in read_counts().items() if c}
    line["split_plain"] = device_split(lambda: score(model, cfg, batch),
                                       MODEL_SPLIT)
    line["max_memory_allocated_plain"] = torch.cuda.max_memory_allocated()
    t = time.perf_counter()
    host = type(model)(tree, cfg).to("cpu")
    want = score(host, cfg, batch)
    line["cpu_s"] = time.perf_counter() - t
    line["card_vs_cpu"] = {"max_abs_err": close_to_cpu(label, plain, want),
                           "tolerance": RECSYS_TOL}

    # (c) the retrieval tower against 10^6 random candidates
    n_cand = dict(arch.SHAPES[3].params)["n_candidates"]
    cand = torch.randn((n_cand, cfg.embed_dim),
                       generator=torch.Generator(device=dev).manual_seed(3),
                       device=dev)
    one = _rows(batch, 0, 1)
    scores1, tower1_s = timed_s(lambda: R.retrieval_scores(
        R.user_vector(model, cfg, one), cand))
    err1 = close_to_cpu(label + " retrieval", scores1, R.retrieval_scores(
        R.user_vector(host, cfg, one), cand.cpu()))
    scores, tower_s = timed_s(lambda: R.retrieval_scores(
        R.user_vector(model, cfg, batch), cand))
    if scores.shape != (RECSYS_BATCH, n_cand) or not bool(
            torch.isfinite(scores).all()):
        raise AssertionError(f"{label}: retrieval scores {scores.shape}")
    line["retrieval"] = {"n_candidates": n_cand, "batch_1_s": tower1_s,
                         "batch_1_max_abs_err": err1,
                         f"batch_{RECSYS_BATCH}_s": tower_s}
    del host, want, cand, scores, scores1

    # (d) private lookups
    budget = PrivacyBudget(epsilon_limit=1e12)
    d, d_a, theta = (cfg.private_lookup_d, cfg.private_lookup_da,
                     cfg.private_lookup_theta)
    line["private"] = priv = {"scheme": "sparse", "d": d, "d_a": d_a,
                              "theta": theta}
    gen = torch.Generator(device=dev).manual_seed(1)
    torch.cuda.reset_peak_memory_stats()
    if cfg.model == "dlrm":
        # the reference example's path; no prefill_cache: one banked plan
        # at this n is a whole plan (≈ 30 B a lookup and row)
        table = tree["embed"]
        store = RecordStore.from_float_table(table)
        if store.packed.data_ptr() != table.data_ptr():
            raise AssertionError(f"{label}: the store copied the table")
        scheme = SparseScheme(d=d, d_a=d_a, theta=theta)
        pipe = ServingPipeline(
            store, scheme, scheduler=BatchScheduler(max_batch=32),
            cache=QueryCache(scheme, store.n, max_entries=1024),
            default_budget=lambda: budget, seed=42, device=dev)
        examples = 4
        few = _rows(batch, 0, examples)
        plain_few = score(model, cfg, few)
        warm = []
        score(model, cfg, _rows(batch, examples, examples + 1),
              lookup_fn=pipeline_lookups(pipe, warm, prefix="warm"))
        first, again = [], []
        spent0 = budget.spent_epsilon
        reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        private = score(model, cfg, few,
                        lookup_fn=pipeline_lookups(pipe, first))
        torch.cuda.synchronize()
        priv["pass_s"] = time.perf_counter() - t
        counts = read_counts()
        spent1 = budget.spent_epsilon
        t = time.perf_counter()
        repeat = score(model, cfg, few,
                       lookup_fn=pipeline_lookups(pipe, again))
        torch.cuda.synchronize()
        priv["repeat_pass_s"] = time.perf_counter() - t
        lookups = examples * cfg.n_sparse
        for f in first:
            if (f["launches"]["indices_from_mask"] != d
                    or f["launches"]["gather_xor"] != d
                    or f["launches"]["xor_fold"] != 0 or f["cache_hits"]):
                raise AssertionError(f"{label}: a flush launched {f}")
        if (any(any(f["launches"].values()) for f in again)
                or sum(f["cache_hits"] for f in again) != lookups):
            raise AssertionError(f"{label}: the repeat pass {again}")
        plan = next(iter(pipe.backend.planner._plans.values()))
        priv.update({
            "path": "ServingPipeline.submit_many", "examples": examples,
            "lookups": lookups, "flat_bucket": plan.bucket,
            "exec_plan": plan.describe(),
            "path_counts": dict(pipe.backend.path_counts),
            "flushes": first, "repeat_flushes": again,
            "warm_up_flush_s": [f["flush_s"] for f in warm],
            "epsilon_per_lookup": pipe.price[0],
            "epsilon_spent_first_pass": spent1 - spent0,
            "epsilon_spent_repeat_pass": budget.spent_epsilon - spent1,
            "private_equals_plain_bits": bit_equal(label, private,
                                                   plain_few),
            "repeat_equals_plain_bits": bit_equal(label, repeat, plain_few),
            "cache_metrics": dict(pipe.cache.metrics),
            "store_bytes": store.nbytes,
        })
        if not math.isclose(priv["epsilon_spent_repeat_pass"],
                            priv["epsilon_spent_first_pass"],
                            rel_tol=1e-12):
            raise AssertionError(f"{label}: the cache hits spent "
                                 f"{priv['epsilon_spent_repeat_pass']}")
        split_lookup = pipeline_lookups(pipe, [], prefix="split")
        priv["split_one_example"] = device_split(
            lambda: score(model, cfg, _rows(batch, 8, 9),
                          lookup_fn=split_lookup), MODEL_SPLIT)
        del pipe, store
    else:
        # FM: both tables, one example (39 lookups a table); DIEN: the item
        # table, 8 examples (800 history lookups, then 8 targets)
        examples = 1 if cfg.model == "fm" else 8
        pes = {tree[k].data_ptr(): PrivateEmbedding.create(
                   tree[k], scheme="sparse", d=d, d_a=d_a, theta=theta,
                   budget=budget) for k in tables}
        counted = {"xor_fold": xor_fold}
        few = _rows(batch, 0, examples)
        plain_few = score(model, cfg, few)
        score(model, cfg, _rows(batch, examples, 2 * examples),
              lookup_fn=private_lookups(pes, gen, counted, []))
        log = []
        spent0 = budget.spent_epsilon
        reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        private = score(model, cfg, few,
                        lookup_fn=private_lookups(pes, gen, counted, log))
        torch.cuda.synchronize()
        priv["pass_s"] = time.perf_counter() - t
        counts = read_counts()
        calls = 2                  # FM: embed, linear; DIEN: hist, target
        if len(log) != calls or any(c["xor_fold"] != d for c in log):
            raise AssertionError(f"{label}: lookup calls {log}")
        pe = next(iter(pes.values()))
        priv.update({
            "path": "PrivateEmbedding.lookup", "examples": examples,
            "lookups": sum(math.prod(c["ids"]) for c in log),
            "calls": log, "epsilon_per_lookup": pe.epsilon_per_lookup(),
            "epsilon_spent": budget.spent_epsilon - spent0,
            "private_equals_plain_bits": bit_equal(label, private,
                                                   plain_few),
            "store_bytes": sum(p._store.nbytes for p in pes.values()),
        })
        priv["split_pass"] = device_split(
            lambda: score(model, cfg, few,
                          lookup_fn=private_lookups(pes, gen, counted, [])),
            MODEL_SPLIT)
        del pes
    priv["launches"] = {k: c for k, c in counts.items() if c}
    priv["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    line["seconds"] = time.perf_counter() - t_phase
    emit(line)
    del model, tree
    lm_phase_end()
    return counts


def serve_bert4rec_masked_xent(dev, card, flash, read_counts, reset_counts):
    """BERT4Rec's masked-item loss at its full config (random weights from
    seed 0) on ``bert4rec_batch(cfg, 32)``: the card (``flash_attention.cu``
    once a block) against the CPU. Returns the path's launch counts."""
    from repro_torch.configs import get_arch
    from repro_torch.data import bert4rec_batch
    from repro_torch.models import recsys as R

    t_phase = time.perf_counter()
    lm_phase_start()
    cfg = get_arch("bert4rec").CONFIG
    model = R.bert4rec_init(torch.Generator(device=dev).manual_seed(0), cfg,
                            device=dev)
    users = 32
    batch = bert4rec_batch(cfg, users, seed=0, step=0)
    R.bert4rec_masked_xent(model, cfg, batch)
    reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    loss = R.bert4rec_masked_xent(model, cfg, batch)
    torch.cuda.synchronize()
    loss_s = time.perf_counter() - t
    counts = read_counts()
    if (flash.launches != cfg.n_blocks
            or counts["flash_fwd_kernel"] != cfg.n_blocks):
        raise AssertionError(f"serve_bert4rec_masked_xent: launches {counts}")
    host = R.BERT4Rec(model.tree(), cfg).to("cpu")
    want = R.bert4rec_masked_xent(host, cfg, batch)
    emit({
        "phase": "serve_bert4rec_masked_xent", "card": card,
        "config": cfg.name, "embed_dim": cfg.embed_dim,
        "n_blocks": cfg.n_blocks, "n_heads": cfg.n_heads,
        "seq_len": cfg.seq_len, "items_table": [R.bert4rec_vocab(cfg),
                                                cfg.embed_dim],
        "users": users, "masked": int(batch["mask"].sum()),
        "loss": float(loss), "loss_cpu": float(want),
        "card_vs_cpu": {"max_abs_err": close_to_cpu(
            "serve_bert4rec_masked_xent", loss, want),
            "tolerance": RECSYS_TOL},
        "loss_s": loss_s, "launches": {k: c for k, c in counts.items() if c},
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "split": device_split(lambda: R.bert4rec_masked_xent(
            model, cfg, batch), MODEL_SPLIT),
        "seconds": time.perf_counter() - t_phase,
    })
    del model, host
    lm_phase_end()
    return counts


def _gcn_cfg(sp):
    """gcn-cora's config with the shape's classes (as the reference's
    cells build it)."""
    from repro_torch.configs import get_arch

    return dataclasses.replace(get_arch("gcn-cora").CONFIG,
                               n_classes=sp["n_classes"])


def _gcn_shape(name):
    from repro_torch.configs import get_arch

    return next(s.p() for s in get_arch("gcn-cora").SHAPES if s.name == name)


def serve_gcn_products(dev, card, read_counts, reset_counts):
    """gcn-cora's GCN at ``ogb_products``' shape (2 449 029 nodes,
    61 859 140 edges, 100 features, 47 classes; the graph from
    ``gnn_full_graph(seed=0, pad_to=8)``): ``gcn_apply`` and
    ``node_xent`` on the card, then the same graph on the card's (2, 4)
    mesh under the default rules (nodes and edges over both axes) against
    the unsharded logits. Returns the launch counts (no kernel of the port
    runs here)."""
    from repro_torch.data import gnn_full_graph
    from repro_torch.dist import DEFAULT_RULES, mesh_rules
    from repro_torch.models import gnn as G

    t_phase = time.perf_counter()
    start = lm_phase_start()
    sp = _gcn_shape("ogb_products")
    cfg = _gcn_cfg(sp)
    t = time.perf_counter()
    g = gnn_full_graph(sp["n_nodes"], sp["n_edges"], sp["d_feat"],
                       sp["n_classes"], seed=0, pad_to=8)
    graph_s = time.perf_counter() - t
    n, e = g["feats"].shape[0], g["src"].shape[0]
    t = time.perf_counter()
    card_g = {k: torch.from_numpy(v).to(dev) for k, v in g.items()}
    torch.cuda.synchronize()
    to_card_s = time.perf_counter() - t
    del g
    model = G.gcn_init(torch.Generator(device=dev).manual_seed(0), cfg,
                       sp["d_feat"], device=dev)
    args = [card_g[k] for k in ("feats", "src", "dst", "edge_w", "mean_deg")]
    resident = torch.cuda.memory_allocated() - start
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    logits, apply_s = timed_s(lambda: G.gcn_apply(model, cfg, *args))
    loss, xent_s = timed_s(lambda: G.node_xent(
        logits, card_g["labels"], card_g["label_mask"]))
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    if logits.shape != (n, cfg.n_classes) or not bool(
            torch.isfinite(logits).all()) or not math.isfinite(float(loss)):
        raise AssertionError("serve_gcn_products: logits or loss not finite")
    split = device_split(lambda: G.gcn_apply(model, cfg, *args), MODEL_SPLIT)
    # the mesh: every position all-gathers [N, H] (8 copies on one card)
    # and holds a partial [N, H]: 2 x 8 x N x 47 x 4 B = 7.4 GB at the
    # second layer
    torch.cuda.reset_peak_memory_stats()
    with mesh_rules(_mesh(dev), DEFAULT_RULES):
        sharded, mesh_s = timed_s(lambda: G.gcn_apply(model, cfg, *args))
    mesh_peak = torch.cuda.max_memory_allocated()
    err = float((sharded - logits).abs().max())
    if not torch.allclose(sharded, logits, **RECSYS_TOL):
        raise AssertionError(f"serve_gcn_products: mesh vs unsharded max "
                             f"abs err {err}")
    emit({
        "phase": "serve_gcn_products", "card": card, "config": cfg.name,
        "n_layers": cfg.n_layers, "d_hidden": cfg.d_hidden,
        "aggregator": cfg.aggregator, "norm": cfg.norm, "shape": sp,
        "nodes_padded": n, "edges_padded": e, "graph_host_s": graph_s,
        "graph_to_card_s": to_card_s, "graph_and_weights_bytes": resident,
        "apply_s": apply_s, "node_xent_s": xent_s, "loss": float(loss),
        "max_memory_allocated": peak, "split_apply": split,
        "mesh": {"shape": list(MESH_SHAPE), "rules": "DEFAULT_RULES",
                 "apply_s": mesh_s, "max_abs_err_vs_unsharded": err,
                 "tolerance": RECSYS_TOL,
                 "max_memory_allocated": mesh_peak},
        "launches": {k: c for k, c in counts.items() if c},
        "seconds": time.perf_counter() - t_phase,
    })
    del model, card_g, args, logits, sharded
    lm_phase_end()
    return counts


def serve_gcn_small(dev, card, read_counts, reset_counts):
    """gcn-cora's other shapes, one phase line each: ``full_graph_sm``
    (Cora's size, card against CPU), ``minibatch_lg`` (a Reddit-sized
    random graph, 1024 seeds sampled with fanouts 15 and 10 on the host,
    the subgraph on the card against the CPU) and ``molecule`` (128
    graphs through ``batched_graph_apply``, card against CPU). Returns
    each phase's launch counts."""
    from repro_torch.data import (
        NeighborSampler, gnn_full_graph, molecule_batch,
    )
    from repro_torch.models import gnn as G

    by_path = {}

    def check(label, sp, cfg, fn, args, loss, extra):
        """``fn(model, *args)`` on the card and on the CPU with the same
        weights, ``loss`` of its logits on each."""
        t_phase = time.perf_counter()
        lm_phase_start()
        model = G.gcn_init(torch.Generator(device=dev).manual_seed(0), cfg,
                           sp["d_feat"], device=dev)
        host = G.GCN(model.tree(), cfg).to("cpu")
        on_card = [torch.from_numpy(a).to(dev) for a in args]
        reset_counts()
        logits, apply_s = timed_s(lambda: fn(model, *on_card))
        value, loss_s = timed_s(lambda: loss(logits))
        counts = read_counts()
        want = fn(host, *(torch.from_numpy(a) for a in args))
        emit({
            "phase": label, "card": card, "config": cfg.name,
            "n_layers": cfg.n_layers, "d_hidden": cfg.d_hidden,
            "aggregator": cfg.aggregator, "shape": sp, **extra,
            "apply_s": apply_s, "loss_s": loss_s, "loss": float(value),
            "card_vs_cpu": {"max_abs_err": close_to_cpu(label, logits, want),
                            "loss_err": abs(float(value) - float(loss(want))),
                            "tolerance": RECSYS_TOL},
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "split_apply": device_split(lambda: fn(model, *on_card),
                                        MODEL_SPLIT),
            "launches": {k: c for k, c in counts.items() if c},
            "seconds": time.perf_counter() - t_phase + extra.get("host_s", 0),
        })
        by_path[label] = counts
        del model, host, on_card
        lm_phase_end()

    def apply(m, *a):
        return G.gcn_apply(m, m.cfg, *a)

    sp = _gcn_shape("full_graph_sm")
    g = gnn_full_graph(sp["n_nodes"], sp["n_edges"], sp["d_feat"],
                       sp["n_classes"], seed=0)
    check("serve_gcn_cora", sp, _gcn_cfg(sp), apply,
          [g[k] for k in ("feats", "src", "dst", "edge_w", "mean_deg")],
          lambda lg: G.node_xent(lg, g["labels"], g["label_mask"]), {})

    sp = _gcn_shape("minibatch_lg")
    fanouts = (sp["fanout1"], sp["fanout2"])
    t = time.perf_counter()
    sampler = NeighborSampler.random_graph(
        sp["n_nodes"], sp["n_edges"] // sp["n_nodes"], sp["d_feat"],
        sp["n_classes"], fanouts=fanouts, seed=0)
    graph_s = time.perf_counter() - t
    seeds = np.random.default_rng(0).choice(sp["n_nodes"], sp["batch_nodes"],
                                            replace=False)
    t = time.perf_counter()
    sub = sampler.sample(seeds, step=0)
    sample_s = time.perf_counter() - t
    shapes = NeighborSampler.subgraph_shapes(sp["batch_nodes"], *fanouts,
                                             sp["d_feat"])
    if (sub["nodes"].shape[0], sub["src"].shape[0]) != shapes:
        raise AssertionError(f"serve_gcn_minibatch: subgraph {shapes}")
    del sampler
    check("serve_gcn_minibatch", sp, _gcn_cfg(sp), apply,
          [sub[k] for k in ("feats", "src", "dst", "edge_w")],
          lambda lg: G.node_xent(lg, sub["labels"], sub["seed_mask"]),
          {"avg_degree": sp["n_edges"] // sp["n_nodes"],
           "graph_host_s": graph_s, "sample_host_s": sample_s,
           "host_s": graph_s + sample_s, "sub_nodes": shapes[0],
           "sub_edges": shapes[1]})

    sp = _gcn_shape("molecule")
    mol = molecule_batch(sp["batch"], sp["n_nodes"], sp["n_edges"],
                         sp["d_feat"], sp["n_classes"], seed=0, step=0)
    check("serve_gcn_molecule", sp, _gcn_cfg(sp),
          lambda m, *a: G.batched_graph_apply(m, m.cfg, *a),
          [mol[k] for k in ("feats", "src", "dst", "edge_w")],
          lambda lg: G.graph_xent(lg, mol["labels"]), {})
    return by_path


# ------------------------------------------------------------ training
# card vs CPU, one AdamW step in f32: the loss (relative), each gradient
# leaf against its largest value, the updated parameters where the CPU's
# gradient is above 1e-4 of its leaf's largest (elsewhere AdamW's first
# step is ≈ lr·sign(g) and each side is held to lr (1 + wd·|p|)); the
# limits of test_torch_cuda.py's one-step test
TRAIN_TOL = {"loss_rel": 1e-5, "grads_rel": 1e-4, "params_abs": 1e-5}


def grads_of(loss_fn, params, batch):
    """(loss, gradients in leaf order) of ``loss_fn`` at ``params``."""
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.train_step import value_and_grad

    loss, _, grads = value_and_grad(loss_fn, params, batch)
    return loss, tree_leaves(grads)


def step_card_vs_cpu(label, loss_fn, tree, host, batch, lr=1e-3):
    """One AdamW step of ``loss_fn`` from the same weights on the card
    (``tree``) and on the CPU (``host``): the largest errors of the loss,
    the gradients and the updated parameters, held to ``TRAIN_TOL``."""
    from repro_torch.train import AdamW, make_train_step
    from repro_torch.train.optimizer import tree_leaves

    loss, grads = grads_of(loss_fn, tree, batch)
    want_loss, want_grads = grads_of(loss_fn, host, batch)
    grad_abs, grad_rel = 0.0, 0.0
    for g, w in zip(grads, want_grads):
        g = g.float().cpu()
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{label}: a gradient is not finite")
        err = float((g - w).abs().max()) if g.numel() else 0.0
        grad_abs = max(grad_abs, err)
        grad_rel = max(grad_rel, err / (float(w.abs().max()) or 1.0))
    init_fn, step_fn = make_train_step(loss_fn, AdamW(lr=lr))
    state, metrics = step_fn(init_fn(tree), batch)
    want_state, _ = step_fn(init_fn(host), batch)
    param_abs, small_ok = 0.0, True
    for got, ref, p0, g in zip(tree_leaves(state.params),
                               tree_leaves(want_state.params),
                               tree_leaves(host), want_grads):
        got, big = got.float().cpu(), g.abs() > 1e-4 * float(g.abs().max())
        if bool(big.any()):
            param_abs = max(param_abs, float((got[big] - ref[big]).abs().max()))
        bound = lr * (1 + 0.01 * p0[~big].abs()) * (1 + 1e-5) + 1e-7
        small_ok &= bool(((got[~big] - p0[~big]).abs() <= bound).all())
    loss_err = abs(float(loss) - float(want_loss))
    out = {"loss_card": float(loss), "loss_cpu": float(want_loss),
           "loss_abs_err": loss_err, "grads_max_abs_err": grad_abs,
           "grads_max_err_over_leaf_max": grad_rel,
           "params_max_abs_err": param_abs,
           "small_gradient_moves_within_lr": small_ok,
           "step_loss": float(metrics["loss"]), "tolerance": TRAIN_TOL}
    if (loss_err > TRAIN_TOL["loss_rel"] * max(1.0, abs(float(want_loss)))
            or grad_rel > TRAIN_TOL["grads_rel"]
            or param_abs > TRAIN_TOL["params_abs"] or not small_ok):
        raise AssertionError(f"{label}: card vs CPU {out}")
    return out


def _range_kernels(ev):
    """(name, µs) of every kernel launched under the CPU event ``ev``."""
    out = [(k.name, k.duration) for k in ev.kernels]
    for child in ev.cpu_children:
        out += _range_kernels(child)
    return out


# the attention backward's own range (``layers._FlashAttention.backward``)
# and the one put round the optimizer's update here
RANGES = ("attention_backward", "train:optimizer")


def train_split(opt, loss_fn, state, batches):
    """Device time of ``len(batches)`` training steps by what it does, from
    a torch.profiler trace of the card: the attention backward (the plain
    path recomputed and differentiated inside ``_FlashAttention.
    backward``, under its own profiler range) and the optimizer's update,
    under a range put around it here; the flash forward (the forward and
    the remat's recompute), the GEMMs and the rest by kernel name.
    Measurement only: runs the steps once more."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.train import make_train_step

    class Ranged:
        def init(self, params):
            return opt.init(params)

        def update(self, *args):
            with record_function(RANGES[1]):
                return opt.update(*args)

    _, step = make_train_step(loss_fn, Ranged())

    def group(name):
        return next((g for g, keys in LM_GROUPS.items()
                     if any(k in name for k in keys)), "other")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for b in batches:
            state, _ = step(state, {"tokens": b})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    by_name = {g: 0.0 for g in list(LM_GROUPS) + ["other"]}
    events = 0
    ranged = {"attention_backward": [], "optimizer": []}
    kernels = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.name not in RANGES:
            # (a range also shows on the device's timeline under its own
            # name, spanning its kernels: not a kernel)
            events += 1
            ms = (e.time_range.end - e.time_range.start) / 1e3
            by_name[group(e.name)] += ms
            kernels[e.name] = kernels.get(e.name, 0.0) + ms
        elif e.device_type == DeviceType.CPU and e.name in RANGES:
            ranged[e.name.split(":")[-1]] += _range_kernels(e)
    split = dict(by_name)
    for key, under in ranged.items():
        split[key] = sum(us for _, us in under) / 1e3
        for name, us in under:
            split[group(name)] -= us / 1e3
    busy = sum(by_name.values())
    return {"steps": len(batches), "ms": split, "device_ms": busy,
            "wall_ms": wall * 1e3,
            "busy_share": busy / (wall * 1e3) if wall > 0 else None,
            "device_events": events,
            "attention_backward_share": split["attention_backward"] / busy
            if busy else None,
            # the kernels that take the most device time, wherever they run
            "top_kernels_ms": sorted(kernels.items(), key=lambda kv: -kv[1])[
                :12]}


def train_smollm(dev, card, flash, read_counts, reset_counts):
    """SmolLM-135M trained at full width (``configs/smollm_135m.py``
    ``CONFIG``: 30 layers, d 576, 9/3 heads, vocab 49 152, bf16, remat,
    loss chunks of 512; random weights from seed 0) with
    ``default_optimizer`` (AdamW 3e-4): 20 steps of 8 x 2048 tokens from
    ``lm_batch(seed=0, step=i)``. Each step's loss and host-clock time;
    the flash kernel twice a layer a step (the forward and the remat's
    recompute). Then a torch.profiler split of two more steps. Returns
    the 20 steps' launch counts."""
    import statistics

    from repro_torch.configs import get_arch
    from repro_torch.data import lm_batch
    from repro_torch.models import transformer as T
    from repro_torch.train import make_train_step
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.train_step import default_optimizer, lm_loss_fn

    t_phase = time.perf_counter()
    start = lm_phase_start()
    cfg = get_arch("smollm-135m").CONFIG
    batch, seq, steps = 8, 2048, 20
    opt = default_optimizer(cfg)
    loss_fn = lm_loss_fn(cfg)
    init_fn, step_fn = make_train_step(loss_fn, opt)
    state = init_fn(T.init_lm(torch.Generator(device=dev).manual_seed(0), cfg,
                              device=dev))
    params = sum(p.numel() for p in tree_leaves(state.params))
    tokens = [lm_batch(cfg, batch, seq, seed=0, step=i)["tokens"]
              for i in range(steps + 2)]
    reset_counts()
    losses, times = [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, metrics = step_fn(state, {"tokens": tokens[i]})
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    per_step = 2 * cfg.n_layers
    if (flash.launches != per_step * steps
            or counts["flash_wgmma_kernel"] != per_step * steps):
        raise AssertionError(f"train_smollm: flash launches {counts}")
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"train_smollm: losses {losses}")
    median = statistics.median(times[2:])
    launches_per_step = flash.launches / steps
    split = train_split(opt, loss_fn, state, tokens[steps:])
    emit({
        "phase": "train_smollm", "card": card, "config": cfg.name,
        "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "heads": [cfg.n_heads, cfg.n_kv_heads], "vocab": cfg.vocab,
        "dtype": cfg.dtype, "remat": cfg.remat,
        "remat_policy": cfg.remat_policy, "loss_chunk": cfg.loss_chunk,
        "params": params, "optimizer": type(opt).__name__, "lr": opt.lr,
        "batch": batch, "seq": seq, "steps": steps,
        "loss_step_1": losses[0], f"loss_step_{steps}": losses[-1],
        "losses": losses, "step_s": times,
        "median_step_s_steps_3_to_20": median,
        "tokens_per_s": batch * seq / median,
        "flash_launches_per_step": launches_per_step,
        "launches": {k: c for k, c in counts.items() if c},
        "memory_at_start": start, "max_memory_allocated": peak,
        "split": split, "seconds": time.perf_counter() - t_phase,
    })
    del state
    lm_phase_end()
    return counts


def _lm_pair(arch, dev, **over):
    """``arch``'s reduced config (with ``over``), weights from seed 0 on
    the card and the same weights on the CPU carried by ``convert``."""
    from repro_torch import convert
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_arch(arch).reduced(), **over)
    model = T.init_lm(torch.Generator(device=dev).manual_seed(0), cfg,
                      device=dev)
    host = convert.lm_params_from_numpy(convert.lm_params_to_numpy(model),
                                        cfg, device="cpu")
    return cfg, model.tree(), host.tree()


def train_card_vs_cpu(dev, card, flash, read_counts, reset_counts):
    """One training step on the card against the same step on the CPU,
    from weights carried across by ``convert``: reduced SmolLM in f32
    with remat and loss chunks of 8, reduced Moonlight (MoE, its aux
    loss in the loss), reduced gemma-2 (softcaps, window) and BERT4Rec at
    its full config (8 users). Returns the card's launch counts."""
    from repro_torch import convert
    from repro_torch.configs import get_arch
    from repro_torch.data import bert4rec_batch, lm_batch
    from repro_torch.models import recsys as R
    from repro_torch.train.train_step import lm_loss_fn, recsys_loss_fn

    t_phase = time.perf_counter()
    lm_phase_start()
    reset_counts()
    models = {}
    for label, arch, over in (
            ("smollm_reduced_remat", "smollm-135m",
             dict(remat=True, loss_chunk=8)),
            ("moonlight_reduced", "moonshot-v1-16b-a3b", {}),
            ("gemma2_reduced", "gemma2-2b", {})):
        cfg, tree, host = _lm_pair(arch, dev, **over)
        tokens = lm_batch(cfg, 4, 64, seed=0, step=0)["tokens"]
        before = flash.launches
        models[label] = {
            "config": cfg.name, "remat": cfg.remat,
            "loss_chunk": cfg.loss_chunk, "moe": cfg.moe,
            **step_card_vs_cpu(label, lm_loss_fn(cfg), tree, host,
                               {"tokens": tokens}),
            "flash_launches": flash.launches - before}
    cfg = get_arch("bert4rec").CONFIG
    model = R.bert4rec_init(torch.Generator(device=dev).manual_seed(0), cfg,
                            device=dev)
    host = convert.bert4rec_params_from_numpy(
        convert.bert4rec_params_to_numpy(model), cfg, device="cpu")
    before = flash.launches
    models["bert4rec"] = {
        "config": cfg.name, "users": 8,
        **step_card_vs_cpu("bert4rec", recsys_loss_fn(cfg), model.tree(),
                           host.tree(), bert4rec_batch(cfg, 8, seed=0,
                                                       step=0)),
        "flash_launches": flash.launches - before}
    counts = read_counts()
    if flash.launches <= 0:
        raise AssertionError("train_card_vs_cpu: no flash launch")
    emit({"phase": "train_card_vs_cpu", "card": card, "models": models,
          "launches": {k: c for k, c in counts.items() if c},
          "seconds": time.perf_counter() - t_phase})
    lm_phase_end()
    return counts


def train_bert4rec(dev, card, flash, read_counts, reset_counts):
    """BERT4Rec at its full config (random weights from seed 0) trained
    for 6 AdamW steps of ``bert4rec_batch(32, seed=0, step=i)``: the loss
    and host-clock time of each step, the flash kernel once a block a
    forward (no remat). Returns the launch counts."""
    import statistics

    from repro_torch.configs import get_arch
    from repro_torch.data import bert4rec_batch
    from repro_torch.models import recsys as R
    from repro_torch.train import make_train_step
    from repro_torch.train.train_step import default_optimizer, recsys_loss_fn

    t_phase = time.perf_counter()
    lm_phase_start()
    cfg = get_arch("bert4rec").CONFIG
    users, steps = 32, 6
    init_fn, step_fn = make_train_step(recsys_loss_fn(cfg),
                                       default_optimizer(cfg))
    state = init_fn(R.bert4rec_init(torch.Generator(device=dev).manual_seed(0),
                                    cfg, device=dev))
    batches = [bert4rec_batch(cfg, users, seed=0, step=i)
               for i in range(steps)]
    reset_counts()
    losses, times = [], []
    for b in batches:
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, metrics = step_fn(state, b)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    counts = read_counts()
    if (flash.launches != cfg.n_blocks * steps
            or counts["flash_fwd_kernel"] != cfg.n_blocks * steps):
        raise AssertionError(f"train_bert4rec: launches {counts}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train_bert4rec: losses {losses}")
    emit({"phase": "train_bert4rec", "card": card, "config": cfg.name,
          "users": users, "steps": steps, "losses": losses, "step_s": times,
          "median_step_s": statistics.median(times[1:]),
          "flash_launches_per_step": flash.launches / steps,
          "launches": {k: c for k, c in counts.items() if c},
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "seconds": time.perf_counter() - t_phase})
    del state
    lm_phase_end()
    return counts


def train_gcn(dev, card, read_counts, reset_counts):
    """gcn-cora trained full-graph at Cora's shape (``full_graph_sm``) and
    on the molecule batch (``molecule``: 128 graphs), 10 AdamW steps each:
    each step's loss and host-clock time. No kernel of the port runs
    here. Returns each run's launch counts."""
    import statistics

    from repro_torch.data import gnn_full_graph, molecule_batch
    from repro_torch.models import gnn as G
    from repro_torch.train.train_step import (
        default_optimizer, gnn_full_loss_fn, gnn_molecule_loss_fn,
    )
    from repro_torch.train import make_train_step

    t_phase = time.perf_counter()
    lm_phase_start()
    runs, by_path = {}, {}
    sp = _gcn_shape("full_graph_sm")
    g = gnn_full_graph(sp["n_nodes"], sp["n_edges"], sp["d_feat"],
                       sp["n_classes"], seed=0)
    mp = _gcn_shape("molecule")
    mol = molecule_batch(mp["batch"], mp["n_nodes"], mp["n_edges"],
                         mp["d_feat"], mp["n_classes"], seed=0, step=0)
    for label, shape, batch, loss_fn in (
            ("cora", sp, g, gnn_full_loss_fn),
            ("molecule", mp, mol, gnn_molecule_loss_fn)):
        cfg = _gcn_cfg(shape)
        batch = {k: torch.from_numpy(np.asarray(v)).to(dev)
                 for k, v in batch.items() if isinstance(v, np.ndarray)}
        init_fn, step_fn = make_train_step(loss_fn(cfg),
                                           default_optimizer(cfg))
        state = init_fn(G.gcn_init(torch.Generator(device=dev).manual_seed(0),
                                   cfg, shape["d_feat"], device=dev))
        reset_counts()
        losses, times = [], []
        for _ in range(10):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, metrics = step_fn(state, batch)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        by_path[f"train_gcn_{label}"] = read_counts()
        if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
            raise AssertionError(f"train_gcn {label}: losses {losses}")
        runs[label] = {"shape": shape, "losses": losses, "step_s": times,
                       "median_step_s": statistics.median(times[1:])}
    emit({"phase": "train_gcn", "card": card, "runs": runs,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "seconds": time.perf_counter() - t_phase})
    lm_phase_end()
    return by_path


RESUME_TOL = 1e-5


def train_resume(dev, card, flash, read_counts, reset_counts):
    """``launch/train.py`` on the card with reduced SmolLM: 4 steps
    unbroken against 2 steps, an async save, a restore into a fresh state
    and 2 more steps (``--resume``); the two final checkpoints' largest
    difference is held to ``RESUME_TOL`` (on the card the embedding's and
    the gathers' backward add by atomics; the CPU test holds them bit for
    bit). Then 25 steps with and without ``--compress-grads``' int8 error
    feedback (AdamW 1e-3, 8 x 32 tokens, as the reference's
    tests/test_substrate.py asks): the compressed loss tracks the plain
    one. Returns the launch counts."""
    import io
    import shutil
    import tempfile

    from repro_torch.configs import get_arch
    from repro_torch.data import lm_batch
    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer as T
    from repro_torch.train import (
        AdamW, CheckpointManager, ErrorFeedbackCompressor, make_train_step,
    )
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.train_step import lm_loss_fn

    t_phase = time.perf_counter()
    lm_phase_start()
    cfg = get_arch("smollm-135m").reduced()
    (ROOT / "build").mkdir(exist_ok=True)
    root = tempfile.mkdtemp(prefix="train_resume_", dir=ROOT / "build")
    reset_counts()
    try:
        common = ["--arch", "smollm-135m", "--reduced", "--batch", "8",
                  "--seq", "32", "--log-every", "1"]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            launch_train.main(common + ["--steps", "4", "--ckpt-dir",
                                        f"{root}/a"])
            launch_train.main(common + ["--steps", "2", "--ckpt-every", "2",
                                        "--ckpt-dir", f"{root}/b"])
            launch_train.main(common + ["--steps", "4", "--resume",
                                        "--ckpt-dir", f"{root}/b"])
        log = out.getvalue()
        if "resumed from step 2" not in log:
            raise AssertionError(f"train_resume: {log}")
        init_fn, _ = make_train_step(lm_loss_fn(cfg), AdamW())
        template = init_fn(T.init_lm(torch.Generator(device=dev).manual_seed(9),
                                     cfg, device=dev))
        a, man_a = CheckpointManager(f"{root}/a").restore(template)
        b, man_b = CheckpointManager(f"{root}/b").restore(template)
        diff = max(float((x.float() - y.float()).abs().max())
                   for x, y in zip(tree_leaves(a), tree_leaves(b)))
        if man_a["step"] != 4 or man_b["step"] != 4 or diff > RESUME_TOL:
            raise AssertionError(f"train_resume: resumed run differs by {diff}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    losses = {}
    for name, comp in (("plain", None),
                       ("compressed", ErrorFeedbackCompressor(True))):
        init_fn, step_fn = make_train_step(lm_loss_fn(cfg), AdamW(lr=1e-3),
                                           comp)
        state = init_fn(T.init_lm(torch.Generator(device=dev).manual_seed(0),
                                  cfg, device=dev))
        losses[name] = []
        for i in range(25):
            state, m = step_fn(state, {"tokens": lm_batch(cfg, 8, 32, 0, i)[
                "tokens"]})
            losses[name].append(float(m["loss"]))
    counts = read_counts()
    gap = abs(losses["compressed"][-1] - losses["plain"][-1])
    if gap >= 0.25 or losses["compressed"][-1] >= losses["compressed"][0] - 0.3:
        raise AssertionError(f"train_resume: compressed training {losses}")
    emit({"phase": "train_resume", "card": card, "config": cfg.name,
          "resumed_vs_unbroken_max_abs_diff": diff, "tolerance": RESUME_TOL,
          "log": log.splitlines(), "losses": losses,
          "compressed_vs_plain_final_gap": gap,
          "launches": {k: c for k, c in counts.items() if c},
          "seconds": time.perf_counter() - t_phase})
    lm_phase_end()
    return counts


# ---------------------------------------------- the cells of launch/cells.py
# the five cells each run (the others run when their count fits), the mesh
# each runs on (pir-ct on the one-card mesh of 8 positions, the reference's
# xorbfly rules), and the share of the card's free memory a cell may take
CELLS_CARD = (("pir-ct", "serve_online"), ("pir-ct", "serve_batch"),
              ("smollm-135m", "prefill_32k"), ("bert4rec", "serve_p99"),
              ("gcn-cora", "full_graph_sm"))
CELLS_FIT = 0.9
# card against CPU at a cut shape: the port's card tests' tolerance for its
# models (tests/test_torch_cuda.py, reduced models against the CPU)
CELL_TOL = {"rtol": 1e-4, "atol": 1e-4}


def _spec(arch, name, **over):
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec

    sp = next(s for s in get_arch(arch).SHAPES if s.name == name)
    return ShapeSpec.make(sp.name, sp.kind, **dict(sp.p(), **over)) if over \
        else sp


def _cell_mesh(arch, device, one=False):
    """The mesh a cell runs on: pir-ct's on the 8 positions of the card,
    the others (and any cell when ``one``) on one position."""
    from repro_torch.dist import make_mesh

    shape = MESH_SHAPE if arch == "pir-ct" and not one else (1, 1)
    return make_mesh(shape, ("data", "model"), [device])


def _cell_rules(sp):
    from repro_torch.launch.cells import rules_for_cell

    return _rules(**rules_for_cell(sp))


def _count_cell(arch, sp, one=False):
    """The cell's meta count on the mesh it runs on: its arguments' bytes
    at one position and in all (on one card every position's blocks lie
    on the card), the counted peak, flops and kernels."""
    from repro_torch.dist import mesh_rules
    from repro_torch.launch.cells import build_cell_sanitized
    from repro_torch.launch.dryrun import arg_bytes_per_position
    from repro_torch.launch.op_cost import _tensors, count_cost

    with mesh_rules(_cell_mesh(arch, "meta", one), _cell_rules(sp)):
        cell = build_cell_sanitized(arch, sp, device="meta")
        if cell.skip_reason:
            return None
        cost = count_cost(cell.fn, *cell.args)
        return {"args_bytes": arg_bytes_per_position(cell.args,
                                                     cell.in_shardings),
                "args_bytes_all": sum(
                    t.numel() * t.element_size()
                    for t in _tensors(cell.args)),
                "peak_bytes": cost.peak_bytes, "flops": cost.flops,
                "kernels": dict(cost.kernels)}


def _tree_close(label, got, want, tol):
    """Every tensor of ``got`` (the card's) against ``want`` (the CPU's):
    the same shape, finite, within ``tol``; the largest absolute error."""
    if isinstance(want, torch.Tensor):
        if not want.is_floating_point():
            if not torch.equal(got.cpu(), want):
                raise AssertionError(f"{label}: integers differ")
            return 0.0
        return close_to_cpu(label, got.float(), want.float(), tol)
    if isinstance(want, dict):
        return max([_tree_close(f"{label}/{k}", got[k], v, tol)
                    for k, v in want.items()] or [0.0])
    if isinstance(want, (list, tuple)):
        return max([_tree_close(f"{label}/{i}", g, w, tol)
                    for i, (g, w) in enumerate(zip(got, want))] or [0.0])
    return 0.0


def _run_cell(arch, sp, dev, read_counts, reset_counts, counted):
    """Build the cell on the card at its full shape and run it: a warm-up,
    then ``runs`` timed by CUDA events; the peak above the start beside
    the counted one, each kernel's launches a run."""
    from repro_torch.dist import mesh_rules
    from repro_torch.launch.cells import build_cell_sanitized

    gc.collect()
    torch.cuda.empty_cache()
    at_start = torch.cuda.memory_allocated()
    mesh = _cell_mesh(arch, dev)
    with mesh_rules(mesh, _cell_rules(sp)):
        t = time.perf_counter()
        cell = build_cell_sanitized(arch, sp, device=dev, seed=0)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t
        args_bytes = torch.cuda.memory_allocated() - at_start
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t = time.perf_counter()
        out = cell.fn(*cell.args)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t
        runs = 3 if first_s < 2.0 else 2
        times = []
        for _ in range(runs):
            del out
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = cell.fn(*cell.args)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        peak = torch.cuda.max_memory_allocated() - before
        counts = {k: v for k, v in read_counts().items() if v}
    ms = sorted(times)[len(times) // 2]
    line = {
        "arch": arch, "shape": sp.name, "kind": sp.kind,
        "mesh": list(mesh.devices.shape), "build_s": build_s,
        "first_s": first_s, "runs_ms": times, "ms": ms,
        "args_bytes": args_bytes,
        "counted_args_bytes": counted["args_bytes_all"],
        "peak_bytes": peak, "counted_peak_bytes": counted["peak_bytes"],
        "peak_over_counted": (peak / counted["peak_bytes"]
                              if counted["peak_bytes"] else None),
        "launches": counts, "launches_a_run": {
            k: v / (runs + 1) for k, v in counts.items()},
        "counted_kernels": counted["kernels"],
        "model_flops": cell.model_flops, "counted_flops": counted["flops"],
        "model_flops_fraction": cell.model_flops / (ms * 1e-3
                                                    * BF16_FLOPS_PER_S),
    }
    return cell, out, line


def cells_card(dev, card, read_counts, reset_counts):
    """Phase ``cells_card``: every cell of ``launch/cells.py`` counted on
    ``meta`` (a mesh of one position); each whose counted peak plus its
    arguments fits in ``CELLS_FIT`` of the card's free memory built at its
    full shape on the card and run (the five of ``CELLS_CARD`` first, on
    their meshes, counted again there); the PIR answers held bit for bit
    against the fold kernel over the store the planes came from. Returns
    the kernels' launches over the cells' runs."""
    from repro_torch.configs import get_arch, list_archs
    from repro_torch.configs import pir_ct
    from repro_torch.kernels import ops
    from repro_torch.launch import cells as C

    t_phase = time.perf_counter()
    counted, t = {}, time.perf_counter()
    for arch in list_archs():
        for sp in get_arch(arch).SHAPES:
            got = _count_cell(arch, sp, one=True)
            if got is not None:
                counted[arch, sp.name] = got
    count_s = time.perf_counter() - t
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    budget = CELLS_FIT * free
    need = {k: v["args_bytes"] + v["peak_bytes"] for k, v in counted.items()}
    order = list(CELLS_CARD) + sorted(k for k in counted
                                      if k not in CELLS_CARD)
    lines, unfit, totals = [], {}, {}
    for arch, name in order:
        if need[arch, name] > budget:
            unfit[f"{arch}/{name}"] = {
                "counted_args_bytes": counted[arch, name]["args_bytes"],
                "counted_peak_bytes": counted[arch, name]["peak_bytes"],
                "budget_bytes": budget}
            continue
        sp = _spec(arch, name)
        # the five on their own meshes (pir-ct's 8 positions): counted there
        here = (_count_cell(arch, sp) if arch == "pir-ct"
                else counted[arch, name])
        cell, out, line = _run_cell(arch, sp, dev, read_counts, reset_counts,
                                    here)
        if arch == "pir-ct":
            masks, planes = cell.args
            words = C.pir_store_words(pir_ct.CONFIG, planes.shape[0], dev,
                                      seed=0)
            want = ops.server_answer_fold(words, masks)
            line["equals_fold_bits"] = bool(torch.equal(out, want))
            if not line["equals_fold_bits"]:
                raise AssertionError(f"cells_card {arch}/{name}: the parity "
                                     "answer differs from the fold's")
            del words, want
        for k, v in line["launches"].items():
            totals[k] = totals.get(k, 0) + v
        del cell, out
        emit({"phase": "cells_card", "card": card, **line})
        lines.append(line)
    for arch, name in CELLS_CARD:
        if f"{arch}/{name}" in unfit:
            print(f"cells_card: {arch}/{name} does not fit: "
                  f"{unfit[f'{arch}/{name}']}", flush=True)
    by_cell = {f"{l['arch']}/{l['shape']}": l["launches"] for l in lines}
    for arch, name, kernel in (("pir-ct", "serve_online",
                                "parity_matmul_packed"),
                               ("pir-ct", "serve_batch",
                                "parity_matmul_packed"),
                               ("smollm-135m", "prefill_32k",
                                "flash_wgmma_kernel"),
                               ("bert4rec", "serve_p99", "flash_fwd_kernel")):
        if by_cell.get(f"{arch}/{name}", {}).get(kernel, 0) <= 0:
            raise AssertionError(f"cells_card: {arch}/{name} never launched "
                                 f"{kernel}")
    emit({"phase": "cells_card_summary", "card": card,
          "count_s": count_s, "free_bytes": free, "total_bytes": total,
          "total_memory": torch.cuda.get_device_properties(dev).total_memory,
          "budget_bytes": budget, "ran": list(by_cell),
          "did_not_fit": unfit, "seconds": time.perf_counter() - t_phase})
    return totals


def cells_vs_cpu(dev, card):
    """Phase ``cells_vs_cpu``: cells at cut shapes built on the CPU from
    one seed, run there and, their weights and inputs copied, on the card;
    the outputs within ``CELL_TOL``. Cuts: SmolLM's ``reduced()`` (f32)
    prefill of 2 x 256 tokens; BERT4Rec's serve_p99 at 16 users; the GCN's
    full_graph_sm step as it is (2708 nodes)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.cells import build_cell_sanitized, cell_to_device

    cpu = torch.device("cpu")
    cases = (
        ("smollm-135m", _spec("smollm-135m", "prefill_32k", seq_len=256,
                              global_batch=2),
         get_arch("smollm-135m").reduced()),
        ("bert4rec", _spec("bert4rec", "serve_p99", batch=16), None),
        ("gcn-cora", _spec("gcn-cora", "full_graph_sm"), None),
    )
    out = []
    for arch, sp, cfg in cases:
        from repro_torch.dist import mesh_rules

        with mesh_rules(_cell_mesh(arch, cpu), _cell_rules(sp)):
            cell = build_cell_sanitized(arch, sp, device="cpu", seed=0,
                                        cfg=cfg)
            want = cell.fn(*cell.args)
        card_cell = cell_to_device(cell, dev)
        with mesh_rules(_cell_mesh(arch, dev), _cell_rules(sp)):
            got = card_cell.fn(*card_cell.args)
        err = _tree_close(f"cells_vs_cpu {arch}/{sp.name}", got, want,
                          CELL_TOL)
        out.append({"arch": arch, "shape": sp.name, "cut": sp.p(),
                    "config": "reduced()" if cfg is not None else "CONFIG",
                    "max_abs_err": err, "tolerance": CELL_TOL})
        del cell, card_cell, got, want
    emit({"phase": "cells_vs_cpu", "card": card, "cases": out})


def dryrun_meta(card):
    """Phase ``dryrun_meta``: ``dryrun.run_cell`` for the five cells on the
    single-pod mesh of 256 meta positions, each record and its
    ``roofline_row`` (bounds at the H100's peaks, not measurements)."""
    from repro_torch.launch import dryrun, roofline

    out_dir = str(ROOT / "build" / "dryrun_torch")
    rows = []
    for arch, name in CELLS_CARD:
        rec = dryrun.run_cell(arch, _spec(arch, name), False, out_dir,
                              force=True)
        if rec["ok"] is not True:
            raise AssertionError(f"dryrun_meta {arch}/{name}: "
                                 f"{rec.get('error')}")
        rows.append({"record": {k: rec[k] for k in (
            "chips", "flops", "bytes_accessed", "collectives",
            "bytes_per_device", "model_flops", "kernels", "count_s")},
            "roofline": roofline.roofline_row(rec)})
    emit({"phase": "dryrun_meta", "card": card, "cells": rows})


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
    from repro_torch.kernels.sparse_masks import sparse_masks
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
        "sparse_masks": sparse_masks,
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

    rows.append(check_sparse_masks(n, cfg, rng, dev))

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
    # the rest of the LM family's prefills: (g) gemma-2 (2 requests x 8
    # heads, 8192 tokens, head dim 256, bf16, causal, cap 50: wgmma's d-256
    # instance), (g') with its local layers' window of 4096,
    # (h) Mistral-NeMo (4 x 32 heads, 4096 tokens, head dim 128: wgmma at
    # d 128; the plain version held on 32 of the 128 rows), (h') (a) with
    # cap 50 (wgmma's capped instance); (o) the query offset on both
    # kernels: 256 queries at offset 1024 over 1280 keys, causal, with and
    # without a window of 512, bf16 at d 64 and f32 at d 256
    lm_flash_sets = [
        check_flash("g_gemma2_prefill", 2 * 8, 8192, 256, torch.bfloat16,
                    True, None, dev, flash_attention_fwd,
                    flash_attention_plain, softcap=50.0, iters=5),
        check_flash("g2_gemma2_prefill_window_4096", 2 * 8, 8192, 256,
                    torch.bfloat16, True, 4096, dev, flash_attention_fwd,
                    flash_attention_plain, softcap=50.0, iters=5),
        check_flash("h_nemo_prefill", 4 * 32, 4096, 128, torch.bfloat16,
                    True, None, dev, flash_attention_fwd,
                    flash_attention_plain, plain_rows=32),
        check_flash("h2_lm_prefill_cap_50", 4 * 9, 4096, 64, torch.bfloat16,
                    True, None, dev, flash_attention_fwd,
                    flash_attention_plain, softcap=50.0),
    ] + [
        check_flash(f"o_offset_{str(dt)[6:]}_d{d}_window_{w}", 16, 256, d,
                    dt, True, w, dev, flash_attention_fwd,
                    flash_attention_plain, sk=1280, q_offset=1024)
        for dt, d in ((torch.bfloat16, 64), (torch.float32, 256))
        for w in (None, 512)
    ]
    from repro_torch.kernels.flash_attention import _kernel_for
    for fs in flash_sets + lm_flash_sets:
        want = _kernel_for(getattr(torch, fs["shape"]["dtype"]),
                           fs["shape"]["d"])
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
    # a row for each new operand set: launches from the phase that serves
    # its arch, gemma-2's split by the call's window; wgmma's capped
    # instance at d 64 and the offset run on no arch's path (gemma-2 is the
    # capped arch, at head dim 256; prefills start at 0): 0 launches
    paths = {"g_gemma2_prefill": ("serve_lm_gemma2",
                                  "flash_wgmma_kernel:global"),
             "g2_gemma2_prefill_window_4096": (
                 "serve_lm_gemma2", "flash_wgmma_kernel:window_4096"),
             "h_nemo_prefill": ("serve_lm_mistral_nemo",
                                "flash_wgmma_kernel")}
    # what the build made of wgmma's d-256 instances (gemma-2's route):
    # ptxas's registers and spills (when this process built the library;
    # a spill fails the run), and the tensor-core instructions in their SASS
    d256 = "flash_wgmma_kernelILi256E"
    d256_build = [
        {k: e[k] for k in ("entry", "registers", "smem_bytes",
                           "spill_store_bytes", "spill_load_bytes")}
        for e in report["kernels"] if d256 in e["entry"]]
    spilled = [e for e in d256_build
               if e["spill_store_bytes"] or e["spill_load_bytes"]]
    if spilled:
        raise AssertionError(f"wgmma's d-256 instances spill: {spilled}")
    d256_sass = tensor_core_sass(report["library"], d256)
    if len(d256_sass) != 2 or not all(
            c.get("HGMMA", 0) > 0 for c in d256_sass.values()):
        raise AssertionError("wgmma's d-256 instances: no HGMMA in their "
                             f"SASS: {d256_sass}")
    for fs in lm_flash_sets:
        path, counter = paths.get(fs["label"], (None, fs["kernel"]))
        built = ({"build": d256_build, "sass": d256_sass}
                 if fs["label"] in ("g_gemma2_prefill",
                                    "g2_gemma2_prefill_window_4096") else {})
        rows.append({
            "name": f"flash_attention_fwd_{fs['label']}",
            "counter": counter, "route": "cuda", "source": fs["source"],
            "replaces": "src/repro/kernels/flash_attention.py:111",
            "launches": 0, "path": path, "on_path": path is not None,
            **{k: fs[k] for k in (
                "shape", "kernel", "max_abs_err", "tolerance", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms", "library",
                "same_operands_in_f32")},
            **{k: fs[k] for k in ("library_against_plain",
                                  "sdpa_without_cap_ms") if k in fs},
            **built,
        })

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

        def per_batch(before, batches0, what):
            for k in (expect_kernel,) + tuple(expect_also):
                grew = wrappers[k].launches - before[k]
                if grew != cfg_.d:
                    raise AssertionError(
                        f"{label}: {k} launched {grew} times in {what}, "
                        f"expected d={cfg_.d}")
            # a Sparse-PIR plan draws its masks in one launch a batch
            planned = pipe.metrics["batches"] - batches0
            want = planned if cfg_.scheme == "sparse" else 0
            grew = wrappers["sparse_masks"].launches - before["sparse_masks"]
            if grew != want:
                raise AssertionError(
                    f"{label}: sparse_masks launched {grew} times in {what} "
                    f"of {planned} planned batches, expected {want}")

        for f in range(flushes):
            before = {k: f_.launches for k, f_ in wrappers.items()}
            batches0 = pipe.metrics["batches"]
            picks = submit_batch()
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = pipe.flush()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            check(out, picks)
            served += batch
            per_batch(before, batches0, "one batch")
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
            batches0 = pipe.metrics["batches"]
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
            per_batch(before, batches0, "the batch cut into phases")
            line["breakdown"] = {"plan_s": plan_s, "execute_s": execute_s}
            line["launches"] = {k: f_.launches for k, f_ in wrappers.items()}
            # steps of this batch re-run outside the entry points are
            # measurement, not the main path: they wait until the main
            # path's launch counts have been read
            deferred.append((label, pipe, planned))
        if cfg_.scheme == "sparse":
            # one more batch whose plan runs under torch.profiler: the
            # slots are drawn by sparse_masks alone, with no sort
            before = {k: f_.launches for k, f_ in wrappers.items()}
            batches0 = pipe.metrics["batches"]
            picks = submit_batch()
            cut = pipe.take_batch()
            planned, plan_ops = traced_ops(lambda: pipe.plan_requests(cut))
            check({r.client: a for r, a in pipe.execute_planned(planned)},
                  picks)
            per_batch(before, batches0, "the traced batch")
            if any("sort" in name.lower() for name in plan_ops):
                raise AssertionError(f"{label}: the plan sorts: {plan_ops}")
            if not any("sparse_masks" in name for name in plan_ops):
                raise AssertionError(f"{label}: no sparse_masks kernel in "
                                     f"the plan's trace: {plan_ops}")
            line["plan_ops"] = plan_ops
            line["launches"] = {k: f_.launches for k, f_ in wrappers.items()}
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
                 "parity_matmul_packed", "sparse_masks"):
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
             {"gather_xor": d, "indices_from_mask": d, "sparse_masks": 1},
             "sparse", d)):
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

    # ------------------------------------------------ 9c the mesh
    by_path.update(serve_mesh_ct(pir_ct, online, store, dev, rng, smi,
                                 read_counts, reset_counts))
    by_path["serve_mesh_parity_reduced"] = serve_mesh_parity_reduced(
        pir_ct, red, small, dev, rng, smi, read_counts, reset_counts)
    by_path["serve_mesh_live_ct"] = serve_mesh_live_ct(
        pir_ct, online, store, dev, rng, Delta, VersionedStore,
        pir_delta_batch, scatter_rows, smi, read_counts, reset_counts)

    # ------------------------------------ 10 the attention models: SmolLM
    by_path.update(serve_lm_smollm(dev, smi, flash_attention_fwd,
                                   read_counts, reset_counts))
    by_path["decode_mesh_smollm"] = decode_mesh_smollm(
        dev, smi, read_counts, reset_counts)

    # --------------------------------------------- 11 private BERT4Rec
    by_path["serve_private_bert4rec"] = serve_private_bert4rec(
        dev, smi, flash_attention_fwd, xor_fold, read_counts, reset_counts)

    # ------------------------------------- 12 the rest of the LM family
    # each at full width, one at a time: each starts from a collected heap
    # and frees its weights (Moonlight's 55.4 GB and the Kimi layer's
    # 36 GB do not fit together)
    for label, fn in (("serve_lm_gemma2", serve_lm_gemma2),
                      ("serve_lm_mistral_nemo", serve_lm_mistral_nemo),
                      ("serve_lm_moonshot", serve_lm_moonshot),
                      ("serve_lm_kimi_layer", serve_lm_kimi_layer)):
        by_path[label] = fn(dev, smi, flash_attention_fwd, read_counts,
                            reset_counts)
    by_path["moe_mesh_moonshot"] = moe_mesh_moonshot(
        dev, smi, read_counts, reset_counts)

    # ------------------------- 13 the other recommenders and the GCN
    # each at its full config from a collected heap, its tables at full
    # size: FM (39·10^6 rows), DLRM-RM2 (26·10^6 x 64 words, 6.66 GB) and
    # DIEN (10^6 items), each with private lookups on the card; BERT4Rec's
    # loss; the GCN at ogb_products' shape (unsharded and on the mesh) and
    # at its other shapes
    for arch_id in ("fm", "dlrm-rm2", "dien"):
        by_path[f"serve_{arch_id.replace('-', '_')}"] = serve_recsys(
            arch_id, dev, smi, read_counts, reset_counts)
    by_path["serve_bert4rec_masked_xent"] = serve_bert4rec_masked_xent(
        dev, smi, flash_attention_fwd, read_counts, reset_counts)
    by_path["serve_gcn_products"] = serve_gcn_products(
        dev, smi, read_counts, reset_counts)
    by_path.update(serve_gcn_small(dev, smi, read_counts, reset_counts))

    # ------------------------------------------------------ 14 training
    # SmolLM-135M at full width (the flash kernel forward, twice a layer
    # with remat; the plain path's gradient), each model's step on the
    # card against the CPU, BERT4Rec and the GCN trained, and the
    # launcher's resume and int8 error feedback
    by_path["train_smollm"] = train_smollm(
        dev, smi, flash_attention_fwd, read_counts, reset_counts)
    by_path["train_card_vs_cpu"] = train_card_vs_cpu(
        dev, smi, flash_attention_fwd, read_counts, reset_counts)
    by_path["train_bert4rec"] = train_bert4rec(
        dev, smi, flash_attention_fwd, read_counts, reset_counts)
    by_path.update(train_gcn(dev, smi, read_counts, reset_counts))
    by_path["train_resume"] = train_resume(
        dev, smi, flash_attention_fwd, read_counts, reset_counts)

    # ---------------------------- 15 the cells, the dry run, the roofline
    # every cell of launch/cells.py counted on meta; those that fit the card
    # built at full shape and run on it (the PIR answers against the fold
    # bit for bit), three cut cells on the card against the CPU, and the
    # dry run of the five on 256 meta positions with their roofline rows
    by_path["cells_card"] = cells_card(dev, smi, read_counts, reset_counts)
    cells_vs_cpu(dev, smi)
    dryrun_meta(smi)

    # each kernel's count comes from its path, else the first path that
    # runs it; every path's own counts ride along. An operand set on no
    # path keeps 0 launches
    for r in rows:
        if r.get("on_path") is False:
            continue
        counter = r.get("counter", r["name"])
        path = r.get("path") or next(
            (p for p, c in by_path.items() if c.get(counter, 0) > 0), None)
        if path is None or by_path[path][counter] <= 0:
            raise AssertionError(f"no path launched {r['name']}")
        r["launches"] = by_path[path][counter]
        r["launches_by_path"] = {p: c.get(counter, 0)
                                 for p, c in by_path.items()}

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
