#!/usr/bin/env python
"""Banded-SW align dispatch on the GPU: parity first, then its rate.

Prints ONE JSON line:
  {"metric": "bsw_align_gcups", "value": N, "unit": "GCUPS",
   "parity": "ok", "xw": 1024, "batch": B, "card": "...",
   "device": {"platform": "gpu", "kind": "...", "count": n}}

1. Parity: the production engine (CUDA kernel, device walk, lean and
   edits fetch) against the exact oracle (ops/bsw_ref.py) on the
   quirk-lane set of tests/testutil.parity_problems; any mismatch
   raises.
2. Rate: the production fused dispatch (forward + find-max + walk) at
   band 150, XW=1024, the engine's batch size, each call fenced with
   block_until_ready; GCUPS counts logical band cells x_size * 301.

Exits nonzero without a GPU.  The full per-cell benchmark is ROADMAP S1.
"""

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "bench"))
sys.path.insert(0, os.path.join(HERE, "tests"))

XW = 1024
REPS = 20


def parity() -> None:
    import testutil
    from gam_ngs_tpu.ops.bsw_batch import BswEngine
    from gam_ngs_tpu.ops.bsw_ref import bsw_align

    main, neg = testutil.parity_problems()
    for fetch in ("edits", "lean"):
        eng = BswEngine(traceback="device", fetch=fetch)
        for label, probs in (("main", main), ("negbegin", neg)):
            for k, (g, pr) in enumerate(zip(eng.align_many(probs), probs)):
                if not testutil.same_alignment(g, bsw_align(*pr),
                                               fetch == "lean"):
                    raise AssertionError(f"parity {fetch}/{label} problem "
                                         f"{k} differs from the oracle")
        print(f"[bench] parity {fetch}: {len(main) + len(neg)} ok",
              file=sys.stderr)


def main() -> int:
    import jax

    if jax.default_backend() != "gpu":
        print(f"[bench] no GPU (JAX backend {jax.default_backend()!r})",
              file=sys.stderr)
        return 1
    import kernel_cell
    from gam_ngs_tpu.ops.bsw_batch import BswEngine

    parity()
    eng = BswEngine()
    B = eng.max_batch
    fn, args, cells = kernel_cell.dispatch(eng, XW, B)
    t = min(kernel_cell.wall_times(fn, args, REPS))
    d = jax.devices()[0]
    print(json.dumps({
        "metric": "bsw_align_gcups", "value": cells / t / 1e9,
        "unit": "GCUPS", "parity": "ok", "xw": XW, "batch": B,
        "seconds": t, "card": kernel_cell.card(),
        "device": {"platform": d.platform, "kind": d.device_kind,
                   "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
