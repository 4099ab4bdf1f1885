"""The GPU banded-SW kernel (ops/bsw_cuda.cu): build, binding, layout.

The CUDA source is compiled with `nvcc` for sm_90a the first time it is
needed, into `ops/_build/` (gitignored; rebuilt when the source is
newer), and bound to JAX as the XLA FFI target "gam_bsw".  A failed
build raises: there is no quiet fallback to another engine.

Layout of the kernel's direction planes, (B, T, 32) uint16 with
T = steps(XW, band): band cell (x, y) of problem p lives at step
t = 2x + y, slot k = t//2 - x, word dirs[p, t, k // cpl], bits
2*(k % cpl) .. +1, where cpl = cells_per_lane(band).  `StepDirs`
decodes it for the host walker; `encode_steps` builds it from a
(x, y) direction matrix (used by the tests).

The kernel has no CPU form; tests marked `gpu` run it on the card.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import numpy as np

MAX_BAND = 255  # 32 lanes x 8 two-bit slots per 16-bit word, minus one
LANES = 32
SUMMARY = 16    # walk summary ints per problem (13 used)

MODE_FORWARD, MODE_LEAN, MODE_EDITS = 0, 1, 2

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "bsw_cuda.cu")
_SO = os.path.join(_HERE, "_build", "libbsw_cuda.so")
_TARGET = "gam_bsw"

_lock = threading.Lock()
_registered = False


def cells_per_lane(band: int) -> int:
    return -(-(band + 1) // LANES)


def steps(xw: int, band: int) -> int:
    """Anti-diagonal steps covering an XW-row window."""
    return 2 * (xw - 1) + 2 * band + 1


def row_width(band: int) -> int:
    """j-space width of the last-row / diagonal deposits."""
    return 2 * LANES * cells_per_lane(band)


def check_band(band: int) -> None:
    if not 0 <= band <= MAX_BAND:
        raise ValueError(f"band {band} outside the GPU kernel's range "
                         f"[0, {MAX_BAND}]")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the GPU kernel cannot be built "
                       "(needs the CUDA toolkit)")


def build() -> str:
    """Compile the kernel library if missing or stale; return its path."""
    if (os.path.exists(_SO)
            and os.path.getmtime(_SO) >= os.path.getmtime(_SRC)):
        return _SO
    import jax.ffi

    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-I", jax.ffi.include_dir(), "-o", tmp, _SRC]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n"
                           f"{r.stderr[-4000:]}")
    os.replace(tmp, _SO)
    return _SO


def register() -> None:
    """Build (if needed) and register the FFI target once per process."""
    global _registered
    with _lock:
        if _registered:
            return
        import jax
        import jax.ffi

        if jax.default_backend() != "gpu":
            raise RuntimeError("the CUDA banded-SW kernel needs a GPU; "
                               f"JAX backend is {jax.default_backend()!r}")
        lib = ctypes.cdll.LoadLibrary(build())
        jax.ffi.register_ffi_target(_TARGET, jax.ffi.pycapsule(lib.GamBsw),
                                    platform="CUDA")
        _registered = True


def bsw_call(a_win, b_win, params, band: int, mode: int,
             edit_bytes: int = 1):
    """Traceable kernel call.

    a_win (B, AW) uint8 band-aligned windows (AW >= XW + 2*band + 1),
    b_win (B, XW) uint8, params (6, B) int32 rows begin_a, end_a, a_len,
    x_size, force_start, force_end.  Returns (dirs (B, T, 32) uint16,
    rows (B, 2, row_width) int32 = last row and pos_a == end_a diagonal
    in j-space, summary (B, 16) int32, edits (B, edit_bytes) uint8).
    summary columns: final x, final y, steps, matches, gaps in A, gaps
    in B, has-match, first/last match walk coordinates (4), score,
    found.  Mode 0 fills dirs and rows only; modes 1/2 fill summary,
    and mode 2 the 2-bit edit codes in walk order (4 per byte)."""
    import jax
    import jax.numpy as jnp

    check_band(band)
    B, _aw = a_win.shape
    xw = b_win.shape[1]
    out = (jax.ShapeDtypeStruct((B, steps(xw, band), LANES), jnp.uint16),
           jax.ShapeDtypeStruct((B, 2, row_width(band)), jnp.int32),
           jax.ShapeDtypeStruct((B, SUMMARY), jnp.int32),
           jax.ShapeDtypeStruct((B, max(1, edit_bytes)), jnp.uint8))
    return jax.ffi.ffi_call(_TARGET, out)(
        a_win, b_win, params, band=np.int32(band), mode=np.int32(mode))


class StepDirs:
    """dirs[x, y] view of one problem's (T, 32) step-major plane."""

    __slots__ = ("arr", "cpl")

    def __init__(self, arr: np.ndarray, band: int):
        self.arr = arr
        self.cpl = cells_per_lane(band)

    def __getitem__(self, xy):
        x, y = xy
        t = 2 * x + y
        k = (t >> 1) - x
        return (int(self.arr[t, k // self.cpl]) >> (2 * (k % self.cpl))) & 3


def encode_steps(dirs_xy: np.ndarray, band: int, xw: int) -> np.ndarray:
    """(X, 2*band+1) direction codes -> the kernel's (T, 32) plane."""
    cpl = cells_per_lane(band)
    out = np.zeros((steps(xw, band), LANES), np.uint16)
    for x in range(dirs_xy.shape[0]):
        for y in range(dirs_xy.shape[1]):
            t = 2 * x + y
            k = (t >> 1) - x
            out[t, k // cpl] |= np.uint16(
                int(dirs_xy[x, y]) << (2 * (k % cpl)))
    return out
