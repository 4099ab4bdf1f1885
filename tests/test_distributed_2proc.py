"""Real 2-process jax.distributed run (SURVEY.md §4 item 3).

Two CPU processes (gloo collectives) on localhost run the full
create+merge pipeline through the CLI's --coordinator path; host 0's
output files must be byte-identical to a sequential run of the same
inputs.  This exercises the genuine multihost_utils.process_allgather
wire — the in-process lockstep tests (test_create_dist.py) only
simulate it.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import pytest

sys.path.insert(0, os.path.dirname(__file__))
from test_merge_pipeline import _build_inputs  # noqa: E402

_DRIVER = r"""
import sys

workdir, ml, sl, mfa, sfa, coord, nproc, pid = sys.argv[1:9]

if coord:
    from gam_ngs_tpu.parallel.distributed import init_distributed

    init_distributed(coord, int(nproc), int(pid))

from gam_ngs_tpu.models.create import CreateOptions, run_create
from gam_ngs_tpu.models.merge import MergeOptions, run_merge
from gam_ngs_tpu.ops.bsw_batch import BswEngine

run_create(CreateOptions(
    master_bam_file=ml, slave_bam_file=sl, min_block_size=10,
    output_file_prefix=workdir + "/out"), log=lambda *_: None)

run_merge(MergeOptions(
    master_bam_file=ml, slave_bam_file=sl,
    blocks_file=workdir + "/out.blocks",
    master_fasta_file=mfa, slave_fasta_file=sfa, min_block_size=10,
    output_file_prefix=workdir + "/out",
    engine=BswEngine(backend="xla")), log=lambda *_: None)
print("DRIVER_OK", flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cpu_env() -> dict:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _run_pipeline(workdir, inputs, coord: str, nproc: int, pid: int,
                  env) -> tuple[subprocess.Popen, str]:
    ml, sl, mfa, sfa = inputs
    logf = str(workdir / f"driver.{pid}.log")
    with open(logf, "w") as fh:
        p = subprocess.Popen(
            [sys.executable, "-c", _DRIVER, str(workdir), ml, sl, mfa, sfa,
             coord, str(nproc), str(pid)],
            stdout=fh, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=str(workdir))
    return p, logf


def _wait_all(procs: list, timeout_s: float):
    import time

    deadline = time.monotonic() + timeout_s
    for p, logf in procs:
        left = max(deadline - time.monotonic(), 1.0)
        try:
            p.wait(timeout=left)
        except subprocess.TimeoutExpired:
            for q, _ in procs:
                q.kill()
            raise AssertionError(
                f"driver hung; partial log:\n{open(logf).read()[-4000:]}")
    for p, logf in procs:
        out = open(logf).read()
        assert p.returncode == 0 and "DRIVER_OK" in out, \
            f"driver failed:\n{out[-4000:]}"


def test_two_process_pipeline_byte_identical(tmp_path):
    seq_dir = tmp_path / "seq"
    dist_dir = tmp_path / "dist"
    seq_dir.mkdir()
    dist_dir.mkdir()
    _g, ml_s, sl_s, mfa_s, sfa_s = _build_inputs(seq_dir)
    _g, ml_d, sl_d, mfa_d, sfa_d = _build_inputs(dist_dir)
    env = _cpu_env()

    # sequential run (same CPU env, no coordinator) and the 2-process
    # distributed run, all concurrently
    coord = f"127.0.0.1:{_free_port()}"
    procs = [
        _run_pipeline(seq_dir, (ml_s, sl_s, mfa_s, sfa_s), "", 1, 0, env),
        _run_pipeline(dist_dir, (ml_d, sl_d, mfa_d, sfa_d), coord, 2, 0, env),
        _run_pipeline(dist_dir, (ml_d, sl_d, mfa_d, sfa_d), coord, 2, 1, env),
    ]
    _wait_all(procs, 480)

    # host 0 outputs byte-identical to the sequential run
    for name in ("out.blocks", "out.gam.fasta", "out.pctgs",
                 "out.noblocks.BF.fasta", "out.noblocks.AF.fasta",
                 "out.notmerged.fasta", "out.stats"):
        a = (seq_dir / name).read_bytes()
        b = (dist_dir / name).read_bytes()
        assert a == b, f"{name} differs between sequential and 2-process runs"
