"""The GPU kernel (ops/bsw_cuda.cu) and the engine around it.

Tests marked `gpu` run the kernel on the card and skip without one; the
rest check on the CPU what surrounds it: bucket and batch padding, the
band limit, backend resolution, the kernel's direction layout under the
host walker, the compile cache directory, and loud build failures.

The DP is int32 end to end (no float product, so no TF32 question):
every comparison below is exact.
"""

import numpy as np
import pytest

import testutil
from gam_ngs_tpu.ops import bsw_batch, bsw_cuda
from gam_ngs_tpu.ops.bsw_batch import BswEngine, _traceback_from_dirs
from gam_ngs_tpu.ops.bsw_ref import bsw_align

BUCKETS = (128, 256, 384, 512, 768, 1024, 1536, 2048, 3072, 4096)
BIG_BUCKETS = (6144, 8192, 12288, 16384, 24576, 32768)


@pytest.fixture
def gpu():
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (JAX backend is "
                    f"{jax.default_backend()!r})")


def _check(eng, problems, band, label):
    lean = eng._resolve_lean()
    got = eng.align_many(problems)
    for k, pr in enumerate(problems):
        want = bsw_align(*pr, band=band)
        assert testutil.same_alignment(got[k], want, lean), \
            f"{label} problem {k}: score {got[k].score} vs {want.score}"


@pytest.mark.gpu
@pytest.mark.parametrize("traceback,fetch,arena", [
    ("host", "edits", False), ("device", "edits", False),
    ("device", "lean", False), ("device", "edits", True),
    ("device", "lean", True)])
def test_gpu_parity_set(gpu, traceback, fetch, arena):
    main, neg = testutil.parity_problems()
    eng = BswEngine(backend="cuda", traceback=traceback, fetch=fetch)
    if arena:
        eng.register_contigs([pr[0] for pr in main + neg]
                             + [pr[3] for pr in main + neg])
    _check(eng, main, 150, f"{traceback}/{fetch}/arena={arena}")
    _check(eng, neg, 150, f"{traceback}/{fetch}/arena={arena}/negbegin")


@pytest.mark.gpu
def test_gpu_buckets_vs_oracle_and_xla(gpu):
    """Band 150 at every bucket 128..32768 (the largest the 5 Mbp smoke
    corpus uses; the hard corpus's larger ones are byte-diffed end to
    end in chip_smoke.py): up to XW=4096 one problem per bucket against
    the oracle, and at every bucket a batch against the XLA fused path
    on the same card."""
    rng = np.random.default_rng(150)
    cuda = BswEngine(backend="cuda", traceback="device", fetch="edits")
    xla = BswEngine(backend="xla", traceback="device", fetch="edits")
    for xw in BUCKETS + BIG_BUCKETS:
        xs = xw - int(rng.integers(0, xw // 4))
        if xw in BUCKETS:
            _check(cuda, testutil.bucket_problems(rng, xs, 1), 150,
                   f"bucket {xw}")
        batch = testutil.bucket_problems(rng, xs,
                                         24 if xw in BUCKETS else 4)
        for k, (g, w) in enumerate(zip(cuda.align_many(batch),
                                       xla.align_many(batch))):
            assert testutil.same_alignment(g, w, lean=False), \
                f"bucket {xw} problem {k} differs from the XLA path"


@pytest.mark.gpu
def test_gpu_narrow_bands(gpu):
    """Every cells-per-lane instantiation boundary: bands 0..255."""
    rng = np.random.default_rng(31)
    for band in (0, 1, 30, 31, 32, 63, 64, 200, 255):
        eng = BswEngine(band=band, backend="cuda", traceback="device",
                        fetch="edits")
        _check(eng, testutil.bucket_problems(rng, 300, 3, band), band,
               f"band {band}")


def test_band_limit_validation():
    with pytest.raises(ValueError, match="band 256"):
        BswEngine(band=256, backend="cuda")
    assert BswEngine(band=bsw_cuda.MAX_BAND, backend="cuda").band == 255
    # the XLA forward has no such limit
    assert BswEngine(band=300, backend="xla").band == 300


def test_backend_auto_on_cpu():
    eng = BswEngine(band=30)
    assert eng.kernel == "xla"
    assert eng._resolve_traceback() == "host"
    with pytest.raises(ValueError, match="unknown backend"):
        BswEngine(backend="pallas")


def test_backend_auto_on_gpu_never_falls_back(monkeypatch):
    """With a GPU backend "auto" picks the CUDA kernel, the fused
    device walk and the lean fetch; a kernel that cannot be built or
    bound raises instead of running something else."""
    import jax

    monkeypatch.setattr(bsw_batch, "enable_compilation_cache",
                        lambda: None)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    eng = BswEngine(band=150)
    assert eng.kernel == "cuda"
    assert eng._resolve_traceback() == "device"
    assert eng._resolve_lean()
    assert eng.max_batch == 1024
    monkeypatch.setattr(bsw_cuda, "_registered", False)
    monkeypatch.setattr(bsw_cuda, "build", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc failed")))
    a = np.zeros(200, np.uint8)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        eng.align_one(a, 0, 199, a, 0, 199)


def test_register_needs_gpu(monkeypatch):
    monkeypatch.setattr(bsw_cuda, "_registered", False)
    with pytest.raises(RuntimeError, match="needs a GPU"):
        bsw_cuda.register()


def test_build_failure_raises(tmp_path, monkeypatch):
    """A source nvcc cannot compile (or no nvcc at all) raises."""
    bad = tmp_path / "bad.cu"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(bsw_cuda, "_SRC", str(bad))
    monkeypatch.setattr(bsw_cuda, "_SO", str(tmp_path / "b" / "lib.so"))
    with pytest.raises(RuntimeError, match="nvcc"):
        bsw_cuda.build()


def test_pad_dim_buckets():
    got = [BswEngine._pad_dim(n) for n in
           (1, 128, 129, 256, 257, 384, 385, 1000, 1025, 3000, 4096)]
    assert got == [128, 128, 256, 256, 384, 384, 512, 1024, 1536, 3072,
                   4096]
    for n in range(1, 5000, 37):
        p = BswEngine._pad_dim(n)
        assert p >= n and (n <= 256 or p <= 1.5 * n)


def test_pad_batch_and_chunk_sizes():
    from gam_ngs_tpu.parallel import device_mesh

    eng = BswEngine(band=150, backend="cuda")
    assert [eng._pad_batch(n) for n in (1, 8, 9, 64, 65, 1000)] == \
        [8, 8, 16, 64, 128, 1024]
    meshed = BswEngine(band=30, backend="xla", mesh=device_mesh(8))
    assert meshed.max_batch == 64 * 8
    # per device: ceil(9 / 8) = 2 rows -> the 8-row floor, times 8
    assert meshed._pad_batch(9) == 64
    assert meshed._pad_batch(100) == 16 * 8
    # kernel bytes per problem: (2*(XW-1) + 2*band + 1) steps x 64 B
    assert eng._per_problem_bytes(1024, 1024 + 384) == \
        (2 * 1023 + 301) * 64 + 1024 + 384 + 1024


def test_step_layout_decode_and_host_walk():
    """The kernel's step-major direction plane, built from a real
    direction matrix, decodes cell for cell and walks (Python and C++)
    to the same alignment as the byte matrix it came from."""
    import jax.numpy as jnp

    from gam_ngs_tpu.ops.bsw_batch import (_find_max_from, _prepare,
                                           _traceback_native,
                                           forward_builder)

    band = 30
    rng = np.random.default_rng(5)
    a = rng.integers(0, 5, 260).astype(np.uint8)
    b = a[7:240].copy()
    b[::17] = (b[::17] + 1) % 4
    p = _prepare(a, 0, len(a) - 1, b, 0, len(b) - 1, True, False, band)
    xw, yp = 256, 128
    aw = xw + yp
    a_win = np.full((1, aw), 255, np.uint8)
    a_win[0, :len(p.a_win)] = p.a_win
    b_win = np.zeros((1, xw), np.uint8)
    b_win[0, :len(p.b_win)] = p.b_win
    col = lambda v: jnp.asarray([v], jnp.int32)  # noqa: E731
    dirs, last_row, dvacc = forward_builder(1, xw, aw, band)(
        jnp.asarray(a_win), jnp.asarray(b_win), col(p.begin_a),
        col(p.end_a), col(len(a)), col(p.x_size), col(1))
    dirs = np.asarray(dirs)[0, :, :2 * band + 1]
    steps = bsw_cuda.encode_steps(dirs, band, xw)
    view = bsw_cuda.StepDirs(steps, band)
    for x in range(0, xw, 5):
        for y in range(2 * band + 1):
            assert view[x, y] == dirs[x, y]
    diag_is = [i for i in range(p.x_size)
               if 0 <= p.end_a - p.begin_a - i + band < 2 * band + 1]
    diag_vals = [np.asarray(dvacc)[0, p.end_a - p.begin_a - i + band]
                 for i in diag_is]
    found, mi, mj, _score = _find_max_from(np.asarray(last_row)[0],
                                           diag_vals, diag_is, p, band)
    assert found
    want = _traceback_from_dirs(dirs, p, band, mi, mj)
    assert _traceback_from_dirs(view, p, band, mi, mj) == want
    native = _traceback_native(steps, bsw_cuda.cells_per_lane(band), p,
                               band, mi, mj)
    if native is not None:
        assert (list(native[0]), native[1], native[2], native[3]) == \
            (list(want[0]), want[1], want[2], want[3])


@pytest.mark.parametrize("band", [0, 31, 32, 150, 255])
def test_step_layout_geometry(band):
    """Every band cell of every row maps to a distinct (step, word,
    slot) inside the plane the kernel writes."""
    cpl = bsw_cuda.cells_per_lane(band)
    assert cpl <= 8 and 32 * cpl >= band + 1
    xw = 16
    seen = set()
    for x in range(xw):
        for y in range(2 * band + 1):
            t = 2 * x + y
            k = t // 2 - x
            assert 0 <= t < bsw_cuda.steps(xw, band)
            assert 0 <= k < 32 * cpl and 2 * k + (t & 1) == y
            seen.add((t, k))
    assert len(seen) == xw * (2 * band + 1)
    assert bsw_cuda.row_width(band) >= 2 * band + 1


def test_compile_cache_dir(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins and no other directory is set in
    code; without it the cache sits at one fixed path in the checkout."""
    import os

    import jax

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert bsw_batch.compilation_cache_dir() == str(tmp_path)
    updates = []
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.append((k, v)))
    monkeypatch.setattr(bsw_batch.os, "makedirs", lambda *a, **k: None)
    monkeypatch.setattr(bsw_batch, "_cache_enabled", False)
    bsw_batch.enable_compilation_cache()
    assert "jax_compilation_cache_dir" not in dict(updates)

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    fixed = os.path.join(repo, ".jax_cache")
    assert bsw_batch.compilation_cache_dir() == fixed
    updates.clear()
    monkeypatch.setattr(bsw_batch, "_cache_enabled", False)
    bsw_batch.enable_compilation_cache()
    assert dict(updates)["jax_compilation_cache_dir"] == fixed


def test_cli_merge_device_gpu_fails_without_gpu(capsys):
    from gam_ngs_tpu import cli

    rc = cli.main(["merge", "--master-bam", "m.list", "--slave-bam",
                   "s.list", "--blocks-file", "out.blocks",
                   "--master-fasta", "m.fa", "--slave-fasta", "s.fa",
                   "--device", "gpu"])
    assert rc == 1
    assert "no GPU" in capsys.readouterr().err
