"""``repro_torch.launch.dryrun`` and ``repro_torch.launch.roofline``: the
dry run of the reference's three cheap cells (and a skipped one) on the
single-pod mesh of 256 meta positions, the records' keys and per-device
rules, the cache / ``--force`` / retry rules, the roofline terms at the
H100's peaks by hand, and the rendered table."""

import json
import os

import pytest

from repro_torch.configs import get_arch
from repro_torch.launch import dryrun, roofline

KEYS = {"arch", "shape", "kind", "mesh", "chips", "ok", "flops",
        "bytes_accessed", "collectives", "memory", "bytes_per_device",
        "model_flops", "count_s", "kernels"}


def _sp(arch, name):
    return next(s for s in get_arch(arch).SHAPES if s.name == name)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dryrun_torch"))
    recs = {f"{a}/{n}": dryrun.run_cell(a, _sp(a, n), False, out)
            for a, n in (("gcn-cora", "full_graph_sm"),
                         ("pir-ct", "serve_online"),
                         ("smollm-135m", "decode_32k"),
                         ("smollm-135m", "long_500k"))}
    return out, recs


def test_the_cheap_cells_run_and_the_long_one_is_skipped(records):
    out, recs = records
    for tag in ("gcn-cora/full_graph_sm", "pir-ct/serve_online",
                "smollm-135m/decode_32k"):
        rec = recs[tag]
        assert rec["ok"] is True, rec.get("traceback")
        assert set(rec) == KEYS, tag
        assert rec["chips"] == 256 and rec["mesh"] == "pod_16x16"
        assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
        assert set(rec["collectives"]) == {"bytes", "counts", "total_bytes"}
    skip = recs["smollm-135m/long_500k"]
    assert skip["ok"] == "skipped"
    assert skip["skip_reason"] == (
        "pure full-attention arch: 524k-token cell skipped per brief "
        "(DESIGN.md §4 — sub-quadratic attention required)")
    names = sorted(os.listdir(out))
    assert names == sorted(
        f"{t.replace('/', '__')}__pod_16x16.json" for t in recs)


def test_the_per_device_rules(records):
    _, recs = records
    pir = recs["pir-ct/serve_online"]
    # q 8 over n = 10^6 padded to 1 000 192 (a multiple of 256): the
    # kernel's 2·q·n·B spread over 256 positions, one parity launch a
    # position, the 8-round butterfly of the [8, 384] words a position
    n, b, q = -(-1_000_000 // 256) * 256, 12_288, 8
    assert pir["kernels"] == {"parity_matmul_packed": 256}
    assert pir["flops"] == pytest.approx(2 * q * n * b / 256)
    coll = pir["collectives"]
    assert coll["counts"]["collective-permute"] == 8
    assert coll["bytes"]["collective-permute"] == 8 * q * 384 * 4
    assert coll["total_bytes"] == 8 * q * 384 * 4
    # each position's blocks: [8, n/256] masks and [n/256, B] planes
    per_pos = q * n // 256 + n // 256 * b
    assert pir["memory"]["argument_size_in_bytes"] == per_pos
    assert pir["bytes_per_device"] == int(
        per_pos + pir["memory"]["peak_bytes"] / 256)
    assert pir["model_flops"] == 2.0 * q * n * b
    # the model cells report no compiler-inserted collectives; the GCN's
    # aggregation reports its own, the decode's flash-decode its sums
    gcn = recs["gcn-cora/full_graph_sm"]
    assert gcn["collectives"]["counts"]["all-gather"] == 2
    assert gcn["collectives"]["counts"]["reduce-scatter"] == 2
    dec = recs["smollm-135m/decode_32k"]
    assert dec["collectives"]["counts"]["collective-permute"] == 0
    assert dec["kernels"] == {}  # decode attends by the plain softmax


def test_cached_records_are_reused_and_force_recounts(tmp_path, capsys):
    out = str(tmp_path)
    sp = _sp("gcn-cora", "molecule")
    first = dryrun.run_cell("gcn-cora", sp, False, out)
    assert first["ok"] is True
    again = dryrun.run_cell("gcn-cora", sp, False, out)
    assert "[cached]" in capsys.readouterr().out and again == first
    forced = dryrun.run_cell("gcn-cora", sp, False, out, force=True)
    assert "[ok]" in capsys.readouterr().out and forced["ok"] is True


def test_a_cached_failure_is_retried(tmp_path, capsys):
    out = str(tmp_path)
    path = os.path.join(out, "gcn-cora__molecule__pod_16x16.json")
    with open(path, "w") as f:
        json.dump({"ok": False, "error": "RuntimeError: earlier bug"}, f)
    rec = dryrun.run_cell("gcn-cora", _sp("gcn-cora", "molecule"), False, out)
    assert rec["ok"] is True and "[ok]" in capsys.readouterr().out
    with open(path) as f:
        assert json.load(f)["ok"] is True


def test_a_failing_cell_is_recorded_and_main_exits_1(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("a dry-run bug")

    monkeypatch.setattr(dryrun, "build_cell", boom)
    rec = dryrun.run_cell("gcn-cora", _sp("gcn-cora", "molecule"), False,
                          str(tmp_path))
    assert rec["ok"] is False and rec["error"] == "RuntimeError: a dry-run bug"
    assert "traceback" in rec
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "gcn-cora", "--shape", "molecule", "--mesh",
                     "single", "--out", str(tmp_path)])
    assert e.value.code == 1


def test_main_counts_ok_and_skipped(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "smollm-135m", "--shape", "long_500k",
                     "--mesh", "both", "--out", str(tmp_path)])
    assert e.value.code == 0
    assert "0 ok, 2 skipped, 0 FAILED" in capsys.readouterr().out


def test_roofline_terms_by_hand(records):
    _, recs = records
    for rec in (recs["pir-ct/serve_online"], recs["gcn-cora/full_graph_sm"]):
        row = roofline.roofline_row(rec)
        assert row["t_compute_s"] == rec["flops"] / 989e12
        assert row["t_memory_s"] == rec["bytes_accessed"] / 3.35e12
        assert row["t_collective_s"] == (rec["collectives"]["total_bytes"]
                                         / 450e9)
        bound = max(row["t_compute_s"], row["t_memory_s"],
                    row["t_collective_s"])
        assert row["step_lower_bound_s"] == bound
        assert row["roofline_fraction"] == pytest.approx(
            rec["model_flops"] / 256 / 989e12 / bound)
        assert row["model_over_counted_flops"] == pytest.approx(
            rec["model_flops"] / (rec["flops"] * 256))
        assert row["fits_hbm"] == (rec["bytes_per_device"]
                                   <= roofline.HBM_BYTES)
    assert roofline.HBM_BW == 3.35e12 and roofline.LINK_BW == 450e9


def test_render_markdown_has_a_row_per_ok_cell_and_the_skips(records,
                                                             capsys):
    out, recs = records
    roofline.main(["--dir", out, "--write", os.path.join(out, "t.md")])
    text = capsys.readouterr().out
    table = [l for l in text.splitlines() if l.startswith("| ")]
    assert table[0].endswith("| fits HBM |") and "fits16G" not in text
    assert len(table) == 1 + 3  # the header, then one row per ok cell
    assert "Skipped cells (per brief):" in text
    assert "- smollm-135m × long_500k × pod_16x16: pure full-attention" in text
    with open(os.path.join(out, "t.md")) as f:
        assert f.read().startswith("| arch | shape | mesh |")
