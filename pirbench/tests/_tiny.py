"""A cell of BENCHMARK.json at a size the CPU runs in a second: the
deployment's shape (scheme, θ, the scheduler, the cache, the front) at
4096 records of 64 bytes over 4 servers."""

from pirbench import harness

TINY = {"n_records": 4096, "record_bytes": 64, "d": 4, "d_a": 2}


def tiny_cell(workload: str) -> harness.Cell:
    cell = harness.load_cell(workload)
    cell.config.update(TINY)
    if cell.mix["loop"] == "open":
        cell.mix["arrivals"] = {"process": "poisson", "rate_qps": 60.0}
    else:
        cell.mix.update(outstanding=32, preroll=32)
    return cell


def run_tiny(workload: str, seed: int = 2**31 + 11, seconds: float = 1.0,
             trace: bool = False, overrides=None) -> dict:
    return harness.run(tiny_cell(workload), seed, seconds, trace,
                       device="cpu", overrides=overrides)
