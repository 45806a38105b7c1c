"""The harness on the CPU: what it loads by name, its frozen traffic and
arithmetic, its reference, and the rules of a run."""

import json
import math
import os
import pathlib
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from pirbench import harness, reference, schemes, yardstick
from pirbench.traffic import generator

from _tiny import run_tiny, tiny_cell

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_cells_load_by_name(workload):
    cell = harness.load_cell(workload)
    assert cell.config["name"] in workload
    assert cell.mix["loop"] in generator.LOOPS
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(harness.metric_reader(m["name"]))
        assert m["moves"] in {e["name"] for e in cell.end_to_end}


def test_every_metric_has_a_reader_and_names_are_plain():
    for m in BENCH["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))
    names = ([m["name"] for m in BENCH["per_layer"] + BENCH["end_to_end"]]
             + CELLS + [c["name"] for c in BENCH["configs"]])
    assert len(names) == len(set(names))
    for n in names:
        assert all(ch.isascii() and (ch.isalnum() or ch in "_.-") for ch in n)


def test_a_mix_without_its_keys_is_refused(tmp_path):
    poisson = {"process": "poisson", "rate_qps": 5.0}
    (tmp_path / "bad.json").write_text(json.dumps(
        {"loop": "open", "bucket_cap": 8, "arrivals": poisson}))
    with pytest.raises(ValueError, match="population"):
        generator.load_mix("bad", tmp_path)
    (tmp_path / "worse.json").write_text(json.dumps({"loop": "sideways"}))
    with pytest.raises(ValueError, match="loop"):
        generator.load_mix("worse", tmp_path)
    full = {"loop": "open", "bucket_cap": 8, "base_seed": 1,
            "population": {"clients": 4, "zipf_a": 1.3, "repoll_p": 0.2}}
    for arrivals, why in (({"process": "fractal"}, "process"),
                          ({"process": "bursty", "base_qps": 5.0}, "need")):
        (tmp_path / "odd.json").write_text(json.dumps(
            dict(full, arrivals=arrivals)))
        with pytest.raises(ValueError, match=why):
            generator.load_mix("odd", tmp_path)


def test_the_arrival_process_is_chosen_by_name_in_the_mix():
    mix = generator.load_mix("online_q36")
    bursty = dict(mix, arrivals={"process": "bursty", "base_qps": 20.0,
                                 "burst_qps": 120.0, "period_s": 1.0,
                                 "duty": 0.2})
    a = generator.open_schedule(mix, 10**6, 20.0, 5)
    b = generator.open_schedule(bursty, 10**6, 20.0, 5)
    np.testing.assert_array_equal(
        b.times, generator.bursty_times(20.0, 120.0, 1.0, 0.2, 20.0,
                                        mix["base_seed"]))
    assert len(b.times) != len(a.times)
    in_burst = (b.times % 1.0) < 0.2
    assert in_burst.sum() > (~in_burst).sum()


def test_a_configuration_reaches_the_program_whole(tmp_path):
    from repro_torch.configs.base import PIRConfig

    cell = harness.load_cell("ct_sparse.online")
    cfg = harness.pir_config(cell.config, cell.mix)
    assert isinstance(cfg, PIRConfig)
    assert cfg.query_batch == cell.mix["bucket_cap"]
    for k, v in cell.config.items():
        if k not in harness.META_KEYS and k != "query_batch":
            assert getattr(cfg, k) == v, k
    # a field the harness never named by hand still reaches the program
    subset = dict(cell.config, scheme="subset", t=51)
    got = harness.pir_config(subset, cell.mix)
    assert (got.scheme, got.t) == ("subset", 51)
    # a key that is neither a field nor a description is refused
    with pytest.raises(KeyError, match="tau"):
        harness.pir_config(dict(cell.config, tau=3), cell.mix)


def test_a_scheme_the_reference_cannot_judge_is_refused_before_any_work(
        monkeypatch):
    from _tiny import tiny_cell
    from repro_torch.configs.pir_ct import scheme_from_config

    cell = tiny_cell("ct_sparse.online")
    cell.config.update(scheme="as-subset", t=3)
    # the program builds it; the benchmark has no laws for it
    assert scheme_from_config(harness.pir_config(cell.config, cell.mix))
    drawn = []
    monkeypatch.setattr(reference, "store_bytes",
                        lambda *a: drawn.append(a))
    with pytest.raises(ValueError, match="as-subset"):
        harness.set_up(cell, 7, torch.device("cpu"), False)
    assert drawn == []


def test_poisson_and_zipf_are_the_programs_copied():
    from repro_torch.fleet.arrivals import BurstyArrivals, PoissonArrivals
    from repro_torch.fleet.clients import ClientPopulation

    np.testing.assert_array_equal(
        generator.poisson_times(37.5, 12.0, 99),
        PoissonArrivals(37.5).times(12.0, 99))
    np.testing.assert_array_equal(
        generator.bursty_times(10.0, 90.0, 2.0, 0.25, 12.0, 99),
        BurstyArrivals(10.0, 90.0, 2.0, 0.25).times(12.0, 99))
    pop = ClientPopulation(n_clients=500, n_records=10_000, seed=5)
    assert generator.zipf_draw(300, 500, 10_000, 1.3, 0.2, 5) == pop.draw(300)


def test_open_schedule_repeats_and_seeds_only_reorder():
    mix = generator.load_mix("online_q36")
    a = generator.open_schedule(mix, 10**6, 20.0, 2**31 + 3)
    b = generator.open_schedule(mix, 10**6, 20.0, 2**31 + 3)
    c = generator.open_schedule(mix, 10**6, 20.0, 2**31 + 4)
    assert a.lookups == b.lookups
    assert a.lookups != c.lookups
    assert sorted(a.lookups) == sorted(c.lookups)
    np.testing.assert_array_equal(a.times, c.times)
    np.testing.assert_array_equal(
        a.times, generator.poisson_times(36.0, 20.0, mix["base_seed"]))
    assert len(a.times) == pytest.approx(
        mix["arrivals"]["rate_qps"] * 20.0, rel=0.2)


def test_closed_offset_repeats_from_a_seed():
    mix = generator.load_mix("audit_w256")
    assert generator.closed_offset(mix, 10**6, 7) == \
        generator.closed_offset(mix, 10**6, 7)
    assert 0 <= generator.closed_offset(mix, 10**6, 2**31 + 9) < 10**6


def test_percentile_counts_a_missing_lookup_as_a_miss():
    assert harness.percentile([1.0, 2.0, 3.0, 4.0], 50) == \
        pytest.approx(np.percentile([1.0, 2.0, 3.0, 4.0], 50))
    vals = [float(v) for v in range(1, 20)] + [math.inf]
    assert harness.percentile(vals, 95) == math.inf
    assert harness.percentile(vals, 50) == pytest.approx(10.5)
    # the program's SLOCollector drops the miss and reads 18.1 here
    assert harness.percentile(vals[:-1], 95) == pytest.approx(18.1)


def test_interval_union_and_clip():
    merged = yardstick.union([(5, 7), (0, 2), (1, 3), (7, 8)])
    assert merged == [[0, 3], [5, 8]]
    assert yardstick.measure(merged) == 6
    assert yardstick.clip(merged, 2, 6) == [(2, 3), (5, 6)]


def test_least_answer_time_dense_and_sparse():
    n, w = 10**6, 384
    # Chor at 128: every record selected, the packed masks, the answers
    dense = yardstick.answer_s(n, w, 128, 0.5)
    assert dense == pytest.approx(
        (n * w * 4 + 128 * n // 8 + 128 * w * 4) / 3.35e12)
    # one Chor query selects half the store: a gather would read no more
    assert yardstick.answer_s(n, w, 1, 0.5) == pytest.approx(
        (n / 2 * w * 4 + n // 8 + w * 4) / 3.35e12)
    # sparse: the distinct rows, the queries as packed bits (smaller than
    # 2e6 ids here), the answers
    distinct = n * (1 - 0.75 ** 8)
    assert yardstick.answer_s(n, w, 8, 0.25) == pytest.approx(
        (distinct * w * 4 + 8 * n // 8 + 8 * w * 4) / 3.35e12)
    # the ids, where they are the smaller form
    assert yardstick.answer_s(n, w, 8, 1e-4) == pytest.approx(
        (n * (1 - (1 - 1e-4) ** 8) * w * 4 + 8 * n * 1e-4 * 4 + 8 * w * 4)
        / 3.35e12)
    # bytes only: no published compute rate enters the count
    assert not hasattr(yardstick, "XOR_WORDS_PER_S")


def test_least_gather_time():
    w = 384
    # 8 lookups x 1 id a server: the rows, their ids, the rows written
    assert yardstick.gather_s(8, w) == pytest.approx(
        (8 * w * 4 + 8 * 4 + 8 * w * 4) / 3.35e12)
    # an id asked twice is read once and written twice
    assert yardstick.gather_s(8, w, 7) == pytest.approx(
        (7 * w * 4 + 8 * 4 + 8 * w * 4) / 3.35e12)
    # the probe counts each server's distinct ids of a traced index batch
    ids = torch.tensor([[[5], [9], [5], [0]], [[1], [2], [3], [4]]])
    probe = type("P", (), {"shapes": {3: {"ids": ids}}})()
    least = harness.Probe.least_s(probe, w, {
        "scheme": "direct", "n_records": 16, "d": 2, "d_a": 1, "p": 2})
    assert least == {3: pytest.approx(yardstick.gather_s(4, w, 3)
                                      + yardstick.gather_s(4, w, 4))}


def test_reference_answers_a_tiny_store():
    raw = reference.store_bytes(64, 24, 3)
    assert np.array_equal(raw, reference.store_bytes(64, 24, 3))
    rng = np.random.default_rng(0)
    masks = rng.integers(0, 2, size=(3, 64), dtype=np.uint8)
    got = reference.server_answers(reference.word_view(torch.from_numpy(raw)),
                                   torch.from_numpy(masks)).numpy()
    for s in range(3):
        want = np.zeros(24, np.uint8)
        for i in np.nonzero(masks[s])[0]:
            want ^= raw[i]
        assert np.array_equal(got[s], want)
    # the d masks of a query fold to its index
    masks[2] = masks[0] ^ masks[1]
    masks[2, 17] ^= 1
    q = reference.judge_query(torch.from_numpy(masks), 17)
    assert q["parity_ok"] and not reference.judge_query(
        torch.from_numpy(masks), 16)["parity_ok"]


def test_reference_privacy_is_the_papers():
    from repro_torch.core.accounting import epsilon_sparse

    ct = {"n_records": 10**6, "d": 100, "d_a": 50}
    assert schemes.laws("sparse").privacy(dict(ct, theta=0.25)) == \
        (pytest.approx(epsilon_sparse(0.25, 100, 50), rel=1e-12), 0.0)
    chor = schemes.laws("chor")
    assert chor.privacy(ct) == (0.0, 0.0)
    assert reference.weight_moments(chor.density(ct), chor.servers(ct),
                                    odd=False)[0] == pytest.approx(50.0)
    mean, var = reference.weight_moments(0.25, 100, odd=True)
    assert mean == pytest.approx(25.0) and var == pytest.approx(18.75)


def test_density_z_separates_the_drawn_theta_from_another():
    rng = np.random.default_rng(1)
    d, n, queries = 6, 20_000, 4

    def ones(theta):
        total = 0
        for q in range(queries):
            bits = rng.random((n, d)) < theta
            w = bits.sum(axis=1)
            # redraw each column until its parity is right (even, but odd
            # in column q)
            want = np.zeros(n, int)
            want[q] = 1
            bad = (w % 2) != want
            while bad.any():
                bits[bad] = rng.random((int(bad.sum()), d)) < theta
                w = bits.sum(axis=1)
                bad = (w % 2) != want
            total += int(w.sum())
        return total

    assert reference.density_z({d: queries}, 0.25, n, ones(0.25)) < 5
    assert reference.density_z({d: queries}, 0.25, n, ones(0.2)) > 20


@pytest.mark.parametrize("workload", CELLS)
def test_a_tiny_run_is_correct(workload):
    res = run_tiny(workload)
    assert res["correct"], res["limits"]
    assert res["failed"] == 0 and res["attempted"] > 0
    names = {m["name"] for m in harness.load_cell(workload).end_to_end}
    assert set(res["metrics"]) == names
    assert list(res)[-1] == "limits"


def test_a_traced_tiny_run_reads_its_counters():
    res = run_tiny("ct_sparse.online", trace=True)
    assert res["correct"]
    assert 0 < res["metrics"]["batch_fill.p95"]["value"] <= 100
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_traced_open_run_reads_its_tail_and_a_closed_one_none():
    res = run_tiny("ct_sparse.online", trace=True)
    assert res["correct"]
    assert 0 < res["metrics"]["latency_p95_ms"]["value"] < math.inf
    read = harness.metric_reader("latency_p95_ms")
    assert read(types.SimpleNamespace(latencies=None)) is None
    assert read(types.SimpleNamespace(latencies=[0.001] * 19 + [math.inf])
                ) == math.inf


def test_the_set_up_makes_the_copies_buffers_and_warms_the_front():
    """Nothing the Probe copies into is allocated inside the window, and an
    open loop's front has served lookups of its own before it opens."""
    cell = tiny_cell("ct_sparse.online")
    raw, store, fe, probe = harness.set_up(cell, 2**31 + 5,
                                           torch.device("cpu"), False)
    try:
        cap = harness.pir_config(cell.config, cell.mix).query_batch
        warm = sum(harness.buckets(cap))
        # warm() serves every bucket twice on the pipeline, warm_front once
        # more through the started front
        assert fe.metrics["queries"] == 3 * warm
        assert len(probe.slots) == harness.KEEP_BATCHES
        own = {b.untyped_storage().data_ptr()
               for pair in probe.slots for b in pair}
        probe.armed = True
        futures = [fe.submit("c1", i) for i in range(40)]
        for f in futures:
            f.result(timeout=60)
        assert len(probe.kept) == harness.KEEP_BATCHES
        for entry in probe.kept:
            for key in ("queries", "answers"):
                assert entry[key].untyped_storage().data_ptr() in own
    finally:
        fe.close(drain=False)


def test_forbidden_modules_compare_whole_names():
    from pirbench import run

    modules = {"torch": sys, "pirbench.harness": sys,
               "repro_torch.serve": sys, "repro_torch_like": sys}
    assert run.forbidden_modules(modules) == [] or "repro" not in \
        run.forbidden_modules(modules)
    modules["repro.core"] = sys
    assert "repro" in run.forbidden_modules(modules)


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from _tiny import run_tiny\n"
        "from pirbench.run import forbidden_modules\n"
        "assert run_tiny('ct_chor.online', seconds=0.5)['correct']\n"
        "print(forbidden_modules())\n"
    ) % (str(ROOT), str(pathlib.Path(__file__).parent))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _run_cli(cwd):
    return subprocess.run(
        [sys.executable, "pirbench/run.py", "--workload", "ct_sparse.online",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_the_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for hosts without one")
    out = _run_cli(ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_the_run_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "pirbench", tmp_path / "pirbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_cli(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = harness.run(harness.load_cell("ct_chor.online"), 2**31 + 21, 3.0,
                      False)
    assert res["correct"], res["limits"]
    assert res["device"]["platform"] == "gpu"
