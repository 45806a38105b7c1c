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


def scheme_cell(scheme: str, **params) -> harness.Cell:
    """``ct_sparse.online`` at the tiny size, served by ``scheme`` with
    ``params`` (t, p, u): a deployment no configuration file states."""
    cell = tiny_cell("ct_sparse.online")
    cell.name = f"tiny_{scheme}.online"
    cell.config.update(name=f"tiny_{scheme}", scheme=scheme, **params)
    cell.config["limits"] = dict(cell.config["limits"], dummies_z=6.0)
    return cell


def run_cell(cell: harness.Cell, seed: int = 2**31 + 11,
             seconds: float = 1.0, trace: bool = False,
             overrides=None) -> dict:
    return harness.run(cell, seed, seconds, trace, device="cpu",
                       overrides=overrides)


def run_tiny(workload: str, seed: int = 2**31 + 11, seconds: float = 1.0,
             trace: bool = False, overrides=None) -> dict:
    return run_cell(tiny_cell(workload), seed, seconds, trace, overrides)
