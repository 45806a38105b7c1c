#!/usr/bin/env python3
"""``chip_smoke.py``'s phases of the cells alone: the kernels' build, then
``cells_card`` (every cell of ``launch/cells.py`` counted on ``meta``,
each that fits the card built at its full shape and run), ``cells_vs_cpu``
(three cut cells on the card against the CPU) and ``dryrun_meta`` (five
cells on 256 meta positions with their roofline rows), one JSON line a
phase, as the whole script prints them.

    python3 scripts/cells_phases.py

Needs a CUDA device and ``nvcc``; exits non-zero without one.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("cells_phases: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.parity_matmul import parity_matmul_packed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wrappers = {"parity_matmul_packed": parity_matmul_packed,
                "flash_attention_fwd": flash_attention_fwd}

    def reset_counts():
        for fn in wrappers.values():
            fn.launches = 0
        for name in flash_attention_fwd.kernel_launches:
            flash_attention_fwd.kernel_launches[name] = 0

    def read_counts():
        return {**{k: f.launches for k, f in wrappers.items()},
                **flash_attention_fwd.kernel_launches}

    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    CS.emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
             "cuda": torch.version.cuda,
             "total_memory": torch.cuda.get_device_properties(dev).total_memory})
    t = time.perf_counter()
    _build.library()
    CS.emit({"phase": "build", "seconds": time.perf_counter() - t})
    CS.cells_card(dev, smi, read_counts, reset_counts)
    CS.cells_vs_cpu(dev, smi)
    CS.dryrun_meta(smi)
    CS.emit({"phase": "done", "seconds": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
