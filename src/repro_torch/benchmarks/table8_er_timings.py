"""Paper Table 8: Erdős–Rényi generation timings vs edge count.

As ``benchmarks/table8_er_timings.py``, without its ``jax.jit``: the
first draw (key 0) warms up, the second (key 1) is timed to the end of
its work on the device.
"""
from __future__ import annotations

import time

from repro_torch import random as trandom
from repro_torch.benchmarks.common import device_of, emit, row, sync
from repro_torch.core.rmat import sample_erdos_renyi


def run(fast: bool = True, device="cuda"):
    dev = device_of(device)
    rows = []
    sizes = [1 << 18, 1 << 20, 1 << 22] if fast else [1 << 20, 1 << 23,
                                                      1 << 25]
    for e in sizes:
        sample_erdos_renyi(trandom.PRNGKey(0), 1 << 20, 1 << 20, e, dev)
        sync(dev)
        t0 = time.perf_counter()
        src, _ = sample_erdos_renyi(trandom.PRNGKey(1), 1 << 20, 1 << 20, e,
                                    dev)
        sync(dev)
        dt = time.perf_counter() - t0
        rows.append(row(f"table8/er_{e}", dt * 1e6,
                        f"edges={len(src)};eps={e / dt:.3e}"))
    return emit(rows, "table8_er_timings")
