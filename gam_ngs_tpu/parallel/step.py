"""The sharded device pipeline step: batched DP + library statistics.

One jitted function covering the framework's two device workloads,
laid out over the 1-D `(part,)` mesh:

  * the batched banded-SW forward (ops.bsw_batch.forward_builder) with
    the problem batch sharded over the whole mesh — the gam-merge
    analogue of data parallelism (each graph partition's alignments are
    independent, SURVEY.md §2.7);
  * per-library insert-size moment accumulation (count/sum/sumsq, the
    exact sufficient statistics behind MultiBamReader's Welford stream,
    reference lib/src/bam/MultiBamReader.cc:346-430) over a sharded
    read table, reduced to replicated outputs — XLA inserts the psums
    from the sharding annotations alone;
  * a replicated scalar summary (total best score) forcing a full-mesh
    reduction, standing in for the reference's global counters.

No tensor/pipeline parallelism is used on purpose: the DP band (301
lanes) is tiny, so sharding it across devices would only add latency.
See parallel.mesh for the rationale.
"""

from __future__ import annotations

import functools

import numpy as np

from ..ops.bsw_batch import forward_builder
from .mesh import DATA_AXIS


def make_pipeline_step(mesh, B: int, XW: int, AW: int, band: int,
                       n_reads: int, n_libs: int):
    """Build a jitted, mesh-sharded pipeline step.

    Returns fn(a_win, b_win, begin_a, end_a, a_len, x_size,
    force_start, lib_id, isize, read_mask) ->
    (dirs, last_row, diag_vals, lib_count, lib_sum, lib_sumsq,
    total_best).  Batch-leading inputs are sharded over the full mesh;
    statistics and the scalar come back replicated.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    fwd = forward_builder(B, XW, AW, band)

    def step(a_win, b_win, begin_a, end_a, a_len, x_size,
             force_start, lib_id, isize, read_mask):
        dirs, last_row, diag_vals = fwd(
            a_win, b_win, begin_a, end_a, a_len, x_size, force_start)

        # per-library moment accumulation: one-hot segment sums
        onehot = (lib_id[:, None] == jnp.arange(n_libs)[None, :])
        w = jnp.where(read_mask, 1.0, 0.0)[:, None] * onehot
        s = isize.astype(jnp.float64 if jax.config.jax_enable_x64
                         else jnp.float32)
        lib_count = jnp.sum(w, axis=0)
        lib_sum = jnp.sum(w * s[:, None], axis=0)
        lib_sumsq = jnp.sum(w * (s * s)[:, None], axis=0)

        total_best = jnp.sum(jnp.max(last_row, axis=1))
        return (dirs, last_row, diag_vals, lib_count, lib_sum,
                lib_sumsq, total_best)

    batch = NamedSharding(mesh, P(DATA_AXIS))
    repl = NamedSharding(mesh, P())
    in_sh = (batch,) * 7 + (batch, batch, batch)
    out_sh = (batch, batch, batch, repl, repl, repl, repl)
    return jax.jit(step, in_shardings=in_sh, out_shardings=out_sh)


def dryrun_step(mesh, tiny: bool = True):
    """Create tiny sharded inputs, run ONE step on the mesh, and verify
    the replicated statistics against a NumPy recomputation."""
    import jax

    n_dev = mesh.devices.size
    B = 2 * n_dev
    XW = 64
    band = 8
    YP = 128  # pad128(2*band+2)
    AW = 256  # >= XW + YP
    n_reads = 16 * n_dev
    n_libs = 2

    rng = np.random.default_rng(0)
    a = rng.integers(0, 4, size=(B, AW)).astype(np.uint8)
    # b = noisy copy of a's diagonal so alignments are non-trivial
    # (aligned-window semantics: a[k] = contig[begin_a - band + k])
    b = a[:, band:band + XW].copy()
    flip = rng.random(b.shape) < 0.05
    b[flip] = (b[flip] + 1) % 4
    begin_a = np.full(B, band, np.int32)
    end_a = np.full(B, band + XW - 1, np.int32)
    a_len = np.full(B, AW, np.int32)
    x_size = np.full(B, XW, np.int32)
    fstart = np.zeros(B, np.int32)
    lib_id = rng.integers(0, n_libs, size=n_reads).astype(np.int32)
    isize = rng.integers(150, 450, size=n_reads).astype(np.int32)
    mask = rng.random(n_reads) < 0.9

    step = make_pipeline_step(mesh, B, XW, AW, band, n_reads, n_libs)
    out = step(a, b, begin_a, end_a, a_len, x_size, fstart,
               lib_id, isize, mask)
    out = jax.block_until_ready(out)

    lib_count = np.asarray(out[3])
    lib_sum = np.asarray(out[4])
    for lib in range(n_libs):
        sel = mask & (lib_id == lib)
        if not np.isclose(lib_count[lib], sel.sum()):
            raise AssertionError("sharded lib_count mismatch")
        if not np.isclose(lib_sum[lib], isize[sel].sum(), rtol=1e-6):
            raise AssertionError("sharded lib_sum mismatch")
    if float(out[6]) <= 0:
        raise AssertionError("total_best should be positive")

    # and the full shard_map'd engine path (traceback included)
    from ..ops.bsw_batch import BswEngine
    from ..ops.bsw_ref import bsw_align

    eng = BswEngine(band=band, mesh=mesh)
    aa = np.asarray(a[0])
    bb = np.asarray(b[0])
    aln = eng.align_one(aa, band, band + XW - 1, bb, 0, XW - 1)
    want = bsw_align(aa, band, band + XW - 1, bb, 0, XW - 1, band=band)
    if aln.score != want.score:
        raise AssertionError("mesh-sharded engine diverged from oracle")
    return out
