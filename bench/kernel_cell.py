"""The align dispatch at one window bucket: inputs, timing, trace.

Shared by bench.py and chip_smoke.py.  `dispatch(eng, xw, B)` builds
the production fused dispatch (4-bit windows -> forward -> find-max ->
walk) of a BswEngine for B random band-width problems whose x_size
fills the bucket; `wall_times` fences each call with
block_until_ready; `device_times` reads a jax.profiler trace of the
same calls.  GCUPS counts logical band cells, x_size * (2*band + 1).
"""

from __future__ import annotations

import glob
import os
import subprocess
import tempfile
import time

import numpy as np


def card() -> str:
    """`name, power.limit` of the first GPU, as nvidia-smi reports it."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def dispatch(eng, xw: int, B: int, seed: int = 0):
    """(fn, args, cells) for one fused dispatch of B problems of
    x_size == xw (a noisy copy of `a` at a band offset)."""
    band = eng.band
    aw = xw + eng._yp
    rng = np.random.default_rng(seed)
    a_win = rng.integers(0, 4, size=(B, aw)).astype(np.uint8)
    b_win = a_win[:, band:band + xw].copy()
    flip = rng.random(b_win.shape) < 0.05
    b_win[flip] = (b_win[flip] + 1) % 4
    args = (eng._pack4(a_win), eng._pack4(b_win),
            np.full(B, band, np.int32), np.full(B, band + xw - 1, np.int32),
            np.full(B, aw, np.int32), np.full(B, xw, np.int32),
            np.zeros(B, np.int32), np.zeros(B, np.int32))
    lmax = -(-(2 * xw + 2 * band + 8) // 4) * 4
    fn = eng._fused_align(B, xw, aw, lmax, lean=eng._resolve_lean())
    return fn, args, B * xw * (2 * band + 1)


def wall_times(fn, args, reps: int) -> list[float]:
    import jax

    jax.block_until_ready(fn(*args))  # compile + warm
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        out.append(time.perf_counter() - t0)
    return out


def _union_ns(intervals) -> int:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def traced(run, kernel_substr: str = "bsw_kernel") -> dict:
    """Run `run()` under jax.profiler and reduce the trace: window_s
    (host clock around the run), busy_s (union of GPU kernel
    intervals), kernel_s (kernels whose name contains kernel_substr),
    idle_share = 1 - busy_s / window_s, and the stream lines seen."""
    import jax

    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d):
            t0 = time.perf_counter()
            run()
            window = time.perf_counter() - t0
        paths = glob.glob(os.path.join(d, "**", "*.xplane.pb"),
                          recursive=True)
        if not paths:
            raise RuntimeError("profiler wrote no trace")
        prof = jax.profiler.ProfileData.from_file(paths[0])
    spans, named, lines = [], 0, set()
    for plane in prof.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            # kernel executions sit on the per-stream lines; "XLA Ops"/
            # "XLA Modules" re-draw the same time by HLO op and module
            if not line.name.startswith("Stream"):
                continue
            lines.add(line.name)
            for ev in line.events:
                s, dur = int(ev.start_ns), int(ev.duration_ns)
                spans.append((s, s + dur))
                if kernel_substr in ev.name:
                    named += dur
    if not spans:
        raise RuntimeError("no GPU kernel events in the trace")
    busy = _union_ns(spans) / 1e9
    return {"window_s": window, "busy_s": busy, "kernel_s": named / 1e9,
            "idle_share": 1.0 - busy / window, "lines": sorted(lines)}


def device_times(fn, args, reps: int) -> dict:
    """Per call: device busy seconds and bsw_kernel seconds of `reps`
    fenced calls (warmed first), from one profiler trace."""
    import jax

    jax.block_until_ready(fn(*args))
    r = traced(lambda: [jax.block_until_ready(fn(*args))
                        for _ in range(reps)])
    return {"busy_s": r["busy_s"] / reps, "kernel_s": r["kernel_s"] / reps,
            "lines": r["lines"]}
