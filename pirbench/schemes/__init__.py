"""Each scheme's laws, found by the configuration's ``scheme``.

``pirbench/schemes/<scheme>.py`` (``-`` read as ``_``: ``as-sparse`` ->
``as_sparse.py``) holds what the reference needs to judge that scheme, as
the paper states it, and imports nothing of the program:

- ``kind``: the wire the servers see, ``"mask"`` (a query's {0,1} masks,
  one a contacted server) or ``"index"`` (record ids, p a lookup);
- ``privacy(config) -> (ε, δ)`` one lookup costs;
- ``servers(config)``: how many servers a lookup contacts;
- mask kinds: ``density(config)``, the probability a mask bit is drawn
  set (given its column's parity);
- index kinds: ``requests(config)``, the p ids a lookup sends, and
  ``per_server(config)``, the p/d each server receives.

``config`` is the deployment's file as the benchmark reads it; a law
reads the keys its scheme needs (``theta``, ``t``, ``p``, ``u``) and
raises where one is missing.
"""

from __future__ import annotations

import importlib
import pathlib
import types

HERE = pathlib.Path(__file__).resolve().parent


def laws(scheme: str) -> types.ModuleType:
    """The laws file of ``scheme``; a ValueError where there is none."""
    stem = scheme.replace("-", "_")
    if (not stem.isidentifier() or stem.startswith("_")
            or not (HERE / f"{stem}.py").is_file()):
        raise ValueError(f"no laws for scheme {scheme!r} under {HERE}: the "
                         f"reference cannot judge it")
    return importlib.import_module(f"{__name__}.{stem}")


def check_servers(config: dict) -> tuple:
    """(d, d_a) of a deployment, with 0 <= d_a < d."""
    d, d_a = int(config["d"]), int(config["d_a"])
    if not 0 <= d_a < d:
        raise ValueError(f"need 0 <= d_a < d, got d={d}, d_a={d_a}")
    return d, d_a
