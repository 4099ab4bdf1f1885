#!/usr/bin/env python
"""Smoke run of gam create + gam merge on one GPU, kernels included.

    python chip_smoke.py               # one card, the phases below
    python chip_smoke.py --four-cards  # only the 4-card mesh merge

Phases (each prints its own lines; any failure exits nonzero):

  device    card name and power limit (nvidia-smi), JAX devices, compile
            cache directory.  Not a GPU -> exit 1, nothing else runs.
  parity    the `gpu`-marked tests (tests/test_bsw_gpu.py): the CUDA
            kernel against the exact oracle (ops/bsw_ref.py) on the
            quirk-lane and negative-begin set, band-150 problems at
            every bucket 128..32768 (the oracle up to 4096, the XLA
            path on the card at all), lean and edits fetch, host and
            device walk, arena on and off, bands 0..255.
  decision  the CUDA kernel against the plain XLA fused path at band
            150, B = the engine's batch, XW 128/1024/4096: device time
            from a profiler trace, fenced wall time, GCUPS.
  hard      a hard corpus (forks, bubbles, cycles; 1.5 Mbp): gam merge
            on the GPU against the XLA engine on the CPU in a child
            process; the six outputs must be byte-identical.
  main      the 5 Mbp linear corpus through the CLI entry points with
            default options: exact genome reconstruction, phase times,
            aligned cells, dispatches, problems per dispatch; create
            again with the JAX join (same .blocks); the merge again
            warm, traced (device idle share), and with the XLA engine.

--four-cards runs only: a merge through the CLI's mesh path over 4
cards and a 1-card merge of the same multi-component corpus, a byte
diff of the six outputs, and per-card peak memory.

The last line is {"ok": true, "device": {...}} (platform, device_kind,
device count as JAX reports them).  Corpora are generated from fixed
seeds under a temporary directory that is removed at exit.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
for _p in (HERE, os.path.join(HERE, "bench"), os.path.join(HERE, "tests")):
    sys.path.insert(0, _p)

import gam_ngs_tpu  # noqa: E402,F401  (fails outside a checkout)

OUTPUTS = ("gam.fasta", "pctgs", "stats", "noblocks.BF.fasta",
           "noblocks.AF.fasta", "notmerged.fasta")
DECISION_BUCKETS = (128, 1024, 4096)
MAIN_MB, HARD_MB, FOUR_MB = 5.0, 1.5, 5.0  # corpus sizes (Mbp)


def log(*a):
    print(*a, flush=True)


def phase_device(n_cards: int):
    import jax

    import kernel_cell
    from gam_ngs_tpu.ops.bsw_batch import (compilation_cache_dir,
                                           enable_compilation_cache)

    devs = jax.devices()
    d = devs[0]
    log(f"[device] jax {jax.__version__}: platform={d.platform} "
        f"kind={d.device_kind!r} count={len(devs)} "
        f"sms={getattr(d, 'core_count', 'n/a')}")
    if d.platform != "gpu":
        log(f"[device] FAIL: JAX platform is {d.platform!r}, not a GPU")
        sys.exit(1)
    log(f"[device] {kernel_cell.card()}")
    if len(devs) < n_cards:
        log(f"[device] FAIL: need {n_cards} GPUs, JAX sees {len(devs)}")
        sys.exit(1)
    enable_compilation_cache()
    log(f"[device] compile cache: {compilation_cache_dir()} "
        f"(jax_compilation_cache_dir="
        f"{jax.config.jax_compilation_cache_dir!r})")
    return d


def phase_parity():
    import pytest

    t0 = time.time()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly",
                      os.path.join(HERE, "tests", "test_bsw_gpu.py")])
    log(f"[parity] pytest -m gpu rc={int(rc)} in {time.time() - t0:.1f}s")
    if rc != 0:
        raise SystemExit(f"[parity] FAIL (pytest rc={int(rc)})")


def phase_decision(card: str):
    import kernel_cell
    from gam_ngs_tpu.ops.bsw_batch import BswEngine

    B = BswEngine().max_batch
    rows = []
    for xw in DECISION_BUCKETS:
        for backend in ("cuda", "xla"):
            eng = BswEngine(backend=backend, traceback="device",
                            fetch="lean", max_batch=B)
            fn, args, cells = kernel_cell.dispatch(eng, xw, B)
            t0 = time.time()
            wall = kernel_cell.wall_times(fn, args, 5)
            first = time.time() - t0 - sum(wall)
            dev = kernel_cell.device_times(fn, args, 3)
            rec = {"backend": backend, "xw": xw, "batch": B,
                   "wall_s": min(wall), "device_busy_s": dev["busy_s"],
                   "bsw_kernel_s": dev["kernel_s"],
                   "gcups_device": cells / dev["busy_s"] / 1e9,
                   "gcups_wall": cells / min(wall) / 1e9,
                   "compile_and_first_call_s": first}
            rows.append(rec)
            log(f"[decision] {backend:4s} XW={xw:5d} B={B} "
                f"device {dev['busy_s'] * 1e3:.4f} ms "
                f"(bsw_kernel {dev['kernel_s'] * 1e3:.4f} ms) "
                f"wall {min(wall) * 1e3:.4f} ms "
                f"-> {rec['gcups_device']:.3f} GCUPS device, "
                f"{rec['gcups_wall']:.3f} GCUPS wall | {card}")
            if backend == "cuda":
                # forward only (the host-walk dispatch): the rest of the
                # fused kernel's time is find-max + walk
                fwd = kernel_cell.device_times(
                    eng._forward_host(B, xw, xw + eng._yp), args[:7], 3)
                rec["forward_kernel_s"] = fwd["kernel_s"]
                log(f"[decision] cuda XW={xw:5d}: forward-only kernel "
                    f"{fwd['kernel_s'] * 1e3:.4f} ms, find-max + walk "
                    f"{(dev['kernel_s'] - fwd['kernel_s']) * 1e3:.4f} ms; "
                    f"trace lines {dev['lines']}")
    for xw in DECISION_BUCKETS:
        c, x = (r for r in rows if r["xw"] == xw)
        log(f"[decision] XW={xw}: kernel/XLA device-time speedup "
            f"{x['device_busy_s'] / c['device_busy_s']:.2f}x")
    return rows


def _cli(*argv):
    from gam_ngs_tpu import cli

    rc = cli.main([str(a) for a in argv])
    if rc != 0:
        raise SystemExit(f"gam {argv[0]} exited {rc}")


def _metrics(prefix):
    with open(prefix + ".metrics.json") as fh:
        return json.load(fh)


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _same_outputs(p1, p2):
    """Names of the six merge outputs that differ between two runs."""
    return [o for o in OUTPUTS
            if _read(f"{p1}.{o}") != _read(f"{p2}.{o}")]


def _merge_args(c, blocks, out, mbs=None):
    args = ["merge", "--master-bam", c["ml"], "--slave-bam", c["sl"],
            "--blocks-file", blocks, "--master-fasta", c["mfa"],
            "--slave-fasta", c["sfa"], "--output", out]
    if mbs is not None:
        args += ["--min-block-size", mbs]
    return args


def _summary(m):
    cn = m["counters"]
    disp = max(cn.get("align_dispatches", 0), 1)
    phases = {k: round(v, 6) for k, v in m["phases"].items()}
    return (f"phases {json.dumps(phases)} "
            f"aligned_cells={cn.get('aligned_cells')} "
            f"dispatches={cn.get('align_dispatches')} "
            f"problems={cn.get('align_problems')} "
            f"problems/dispatch={cn.get('align_problems', 0) / disp:.1f} "
            f"neg_begin={cn.get('align_neg_begin')} "
            f"buckets={cn.get('align_buckets')} "
            f"row_fill={cn.get('row_fill_pct')}%")


def start_hard(tmp):
    """Generate + create the hard corpus, start the CPU reference merge
    (a child process that never touches the GPU)."""
    from hard_corpus import build_hard_corpus

    d = os.path.join(tmp, "hard")
    os.makedirs(d)
    t0 = time.time()
    c = build_hard_corpus(HARD_MB, d)
    _cli("create", "--master-bam", c["ml"], "--slave-bam", c["sl"],
         "--min-block-size", 10, "--output", f"{d}/out")
    log(f"[hard] corpus {c['units']} units, expect >= {c['expect']}, "
        f"{c['n_pairs']} pairs; generated + created in "
        f"{time.time() - t0:.1f}s")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "gam_ngs_tpu.cli"] + [
        str(a) for a in _merge_args(c, f"{d}/out.blocks", f"{d}/cpu", 10)
    ] + ["--device", "cpu"]
    logf = open(os.path.join(d, "cpu.log"), "w")
    child = subprocess.Popen(cmd, stdout=logf, stderr=subprocess.STDOUT,
                             env=env, cwd=d)
    return c, d, child, logf, time.time()


def phase_hard(c, d, child, logf, t_child):
    t0 = time.time()
    _cli(*_merge_args(c, f"{d}/out.blocks", f"{d}/gpu", 10),
         "--device", "gpu")
    m = _metrics(f"{d}/gpu")
    log(f"[hard] GPU merge {time.time() - t0:.2f}s: {_summary(m)}")
    log(f"[hard] stats: {_read(f'{d}/gpu.stats').decode().split()}")
    rc = child.wait(timeout=900)
    log(f"[hard] CPU reference merge (XLA engine, child process) rc={rc} "
        f"in {time.time() - t_child:.1f}s")
    if rc != 0:
        log(_read(os.path.join(d, "cpu.log")).decode()[-3000:])
        raise SystemExit("[hard] FAIL: CPU reference merge failed")
    diff = _same_outputs(f"{d}/gpu", f"{d}/cpu")
    if diff:
        raise SystemExit(f"[hard] FAIL: outputs differ: {diff}")
    log("[hard] all six outputs byte-identical to the CPU reference")


def phase_main(tmp, card: str):
    import kernel_cell
    from e2e_scale import build_corpus
    from gam_ngs_tpu.io import fasta
    from gam_ngs_tpu.models.merge import MergeOptions, run_merge
    from gam_ngs_tpu.ops.bsw_batch import BswEngine

    d = os.path.join(tmp, "main")
    os.makedirs(d)
    c = build_corpus(MAIN_MB, d)
    t0 = time.time()
    _cli("create", "--master-bam", c["ml"], "--slave-bam", c["sl"],
         "--output", f"{d}/out")
    t_create = time.time() - t0
    # the JAX join (ops/device_join.py) on the card, against the default
    # create engine's .blocks
    t0 = time.time()
    _cli("create", "--master-bam", c["ml"], "--slave-bam", c["sl"],
         "--output", f"{d}/join", "--device", "tpu")
    if _read(f"{d}/join.blocks") != _read(f"{d}/out.blocks"):
        raise SystemExit("[main] FAIL: the JAX join's .blocks differ")
    log(f"[main] create with the JAX join on the card: .blocks identical "
        f"({time.time() - t0:.3f}s, cold)")
    t0 = time.time()
    _cli(*_merge_args(c, f"{d}/out.blocks", f"{d}/gpu"))
    t_merge = time.time() - t0
    merged = sorted((fasta.codes_to_bytes(seq).decode() for _name, seq
                     in fasta.read_fasta(f"{d}/gpu.gam.fasta")),
                    key=len, reverse=True)
    if not merged or merged[0] != c["genome"]:
        raise SystemExit("[main] FAIL: merged assembly does not "
                         "reconstruct the genome")
    m = _metrics(f"{d}/gpu")
    log(f"[main] {MAIN_MB} Mbp: genome reconstructed exactly; create "
        f"{t_create:.3f}s, merge {t_merge:.3f}s (cold) | {card}")
    log(f"[main] cold merge: {_summary(m)}")

    def merge(tag, eng):
        run_merge(MergeOptions(
            master_bam_file=c["ml"], slave_bam_file=c["sl"],
            blocks_file=f"{d}/out.blocks", master_fasta_file=c["mfa"],
            slave_fasta_file=c["sfa"], output_file_prefix=f"{d}/{tag}",
            engine=eng), log=lambda *_: None)

    def again(tag, eng):
        t0 = time.time()
        merge(tag, eng)
        mm = _metrics(f"{d}/{tag}")
        log(f"[main] {tag}: merge {time.time() - t0:.3f}s align "
            f"{mm['phases']['align']:.6f}s: {_summary(mm)} | {card}")
        diff = _same_outputs(f"{d}/gpu", f"{d}/{tag}")
        if diff:
            raise SystemExit(f"[main] FAIL: {tag} outputs differ: {diff}")
        return mm["phases"]["align"]

    a_warm = again("cuda_warm", BswEngine())
    tr = kernel_cell.traced(lambda: merge("cuda_traced", BswEngine()))
    log(f"[main] traced warm merge: window {tr['window_s']:.6f}s, device "
        f"busy {tr['busy_s']:.6f}s (bsw_kernel {tr['kernel_s']:.6f}s), "
        f"idle share {tr['idle_share']:.4f} | {card}")
    again("xla_cold", BswEngine(backend="xla", traceback="device",
                                fetch="lean"))
    a_xla = again("xla_warm", BswEngine(backend="xla", traceback="device",
                                        fetch="lean"))
    log(f"[main] warm align phase: CUDA kernel {a_warm:.6f}s vs XLA "
        f"fused path {a_xla:.6f}s ({a_xla / a_warm:.2f}x) | {card}")


def phase_four_cards(tmp, card: str):
    import jax

    from e2e_scale import build_corpus
    from gam_ngs_tpu.models.merge import MergeOptions, run_merge
    from gam_ngs_tpu.ops.bsw_batch import BswEngine

    d = os.path.join(tmp, "four")
    os.makedirs(d)
    c = build_corpus(FOUR_MB, d, break_every=4)
    _cli("create", "--master-bam", c["ml"], "--slave-bam", c["sl"],
         "--output", f"{d}/out")
    t0 = time.time()
    _cli(*_merge_args(c, f"{d}/out.blocks", f"{d}/mesh4"))
    t4 = time.time() - t0
    peaks = [(dev.memory_stats() or {}).get("peak_bytes_in_use")
             for dev in jax.devices()]
    m4 = _metrics(f"{d}/mesh4")
    log(f"[four] 4-card merge (CLI mesh path) {t4:.3f}s: {_summary(m4)}")
    log(f"[four] per-card peak bytes in use: {peaks} | {card}")
    t0 = time.time()
    run_merge(MergeOptions(
        master_bam_file=c["ml"], slave_bam_file=c["sl"],
        blocks_file=f"{d}/out.blocks", master_fasta_file=c["mfa"],
        slave_fasta_file=c["sfa"], output_file_prefix=f"{d}/one",
        engine=BswEngine()), log=lambda *_: None)
    t1 = time.time() - t0
    m1 = _metrics(f"{d}/one")
    log(f"[four] 1-card merge {t1:.3f}s: {_summary(m1)}")
    diff = _same_outputs(f"{d}/mesh4", f"{d}/one")
    if diff:
        raise SystemExit(f"[four] FAIL: 4-card outputs differ: {diff}")
    log(f"[four] graphs={m4['counters'].get('graphs')}: all six outputs "
        f"byte-identical between 4 cards and 1 card")


def main(argv) -> int:
    four = "--four-cards" in argv
    import jax

    import kernel_cell

    d = phase_device(4 if four else 1)
    card = kernel_cell.card()
    tmp = tempfile.mkdtemp(prefix="gam_smoke_")
    hard = None
    try:
        if four:
            phase_four_cards(tmp, card)
        else:
            hard = start_hard(tmp)
            phase_parity()
            phase_decision(card)
            phase_hard(*hard)
            phase_main(tmp, card)
    finally:
        if hard is not None:
            _c, _d, child, logf, _t = hard
            if child.poll() is None:
                child.kill()
                child.wait()
            logf.close()
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[done] {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
