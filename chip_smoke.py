"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs every phase on one card; any failure exits non-zero and prints no
result line:

1. card       device name/count and ``nvidia-smi`` name + power limit
2. build      nvcc of both kernels (started together), ptxas report
3. tag_probe  the probe kernel vs its plain version, B=65536, A=8 and 16
4. step       the step kernel vs the plain step (CPU) on 1000-access
              prefixes of every workload × preset: oi/od equal
4b. tail      the same on the last 1000 accesses of every paper-scale
              cell, from the state the kernel reached on the rest of the
              trace: every state array equal
5. main       the paper table at scale 1.0 through ``repro_torch.cli
              .run_table`` (12 cells, one launch): every Metrics field
              equal to ``src/repro_torch/data/table_scale1.json``, trend
              verdict true, launch and probe counts of the main path
6. batch      256 lanes (4 presets × 64) at scale 0.05 on one trace, each
              equal to its preset's single-lane run

Then one ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and the
result line ``{"ok": true, "device": {...}}``.  Imports torch, numpy,
the standard library and ``repro_torch`` (from ``src/`` beside this file).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
TAIL = 1000                    # accesses of the long-run window


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def probe_inputs(B: int, A: int, seed: int, device):
    """Seeded probe rows with forced ties: few distinct tags, stamps and
    sequence numbers, a third of the rows full."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    valid = rng.random((B, A)) < 0.85
    valid[: B // 3] = True
    arrs = (rng.integers(0, 6, (B, A)), valid,
            rng.integers(0, 4, (B, A)).astype(np.float64),
            rng.integers(0, 5, (B, A)), rng.integers(0, 6, B))
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrs]


def phase_tag_probe(res: dict) -> None:
    import torch
    from repro_torch.kernels.tag_probe import tag_probe, tag_probe_plain
    dev = torch.device("cuda")
    entries = []
    for A in (8, 16):
        B = 65536
        args = probe_inputs(B, A, seed=A, device=dev)
        got = tag_probe(*args)
        want = tag_probe_plain(*args)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max().item())
        if err != 0:
            raise AssertionError(f"tag_probe A={A}: kernel != plain")
        ms = cuda_ms(lambda: tag_probe(*args))
        plain_ms = cuda_ms(lambda: tag_probe_plain(*args))
        nbytes = B * A * (8 + 1 + 8 + 8) + B * 8 + B * 3 * 4
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        hits = int(got[:, 0].sum().item())
        evicts = int(got[:, 2].sum().item())
        log(f"tag_probe B={B} A={A}: equal (hits={hits} evicts={evicts}) "
            f"kernel_ms={ms} plain_ms={plain_ms} bound_ms={bound} "
            f"(bytes={nbytes})")
        entries.append({"A": A, "B": B, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound, "max_abs_err": float(err)})
    res["tag_probe"] = entries


def prefix(tr: dict, n: int) -> dict:
    sub = dict(tr)
    for k in ("core", "pc", "addr", "write", "tensor", "reuse"):
        sub[k] = tr[k][:n]
    return sub


def phase_step(res: dict, traces: dict) -> None:
    import numpy as np
    from repro_torch.core import engine_torch
    from repro_torch.core.presets import CONFIGS
    cells = [(sp, prefix(tr, 1000)) for sp in CONFIGS
             for tr in traces.values()]
    got = engine_torch.run_cells(cells, device="cuda")
    kstats = dict(engine_torch.last_run_stats)
    t0 = time.perf_counter()
    want = engine_torch.run_cells(cells, device="cpu")
    plain_s = time.perf_counter() - t0
    pstats = dict(engine_torch.last_run_stats)
    err = 0.0
    for (sp, tr), (oi, od), (oi2, od2) in zip(cells, got, want):
        if not (np.array_equal(oi, oi2) and np.array_equal(od, od2)):
            raise AssertionError(f"sim_step {sp.name}/{tr['name']}: "
                                 f"kernel oi/od != plain step")
        err = max(err, float(np.abs(oi - oi2).max()),
                  float(np.abs(od - od2).max()))
    if kstats["tag_probe_main_path_probes"] != \
            pstats["tag_probe_main_path_probes"]:
        raise AssertionError("sim_step: probe counts differ from plain")
    log(f"sim_step prefix 12 lanes x 1000: equal to the plain step; "
        f"kernel_ms={kstats['kernel_ms']} plain_s(cpu)={plain_s} "
        f"probes={kstats['tag_probe_main_path_probes']}")
    res["step"] = {"ms": kstats["kernel_ms"], "plain_ms": plain_s * 1e3,
                   "max_abs_err": err}


def phase_tail(res: dict, traces: dict) -> None:
    """The step kernel vs the plain step at the main path's shapes: each
    paper-scale cell runs its trace but the last TAIL accesses on the
    card, then both finish it from that state (full markov tables, a
    page table long under decay, which no prefix reaches).  The plain
    step cannot run whole traces: it takes on the order of a second per
    1000 accesses per lane on a CPU."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core import engine_torch
    from repro_torch.core.metrics import Metrics
    from repro_torch.core.presets import CONFIGS
    from repro_torch.kernels.sim_step import sim_step

    def window(lane, sl, device=None, **kw):
        return dataclasses.replace(
            lane, xs={k: v[sl].to(device or v.device)
                      for k, v in lane.xs.items()}, **kw)

    golden = json.loads((ROOT / "src/repro_torch/data/table_scale1.json")
                        .read_text())
    cells = [(sp, tr) for sp in CONFIGS for tr in traces.values()]
    lanes = engine_torch.build_lanes(cells, torch.device("cuda"))
    sim_step([window(lane, slice(0, -TAIL)) for lane in lanes])
    head = [engine_torch.export(lane.S, lane.st)[0] for lane in lanes]
    plain = [window(lane, slice(-TAIL, None), "cpu",
                    st={k: v.to("cpu", copy=True)
                        for k, v in lane.st.items()},
                    blk_tab=lane.blk_tab.cpu()) for lane in lanes]
    sim_step([window(lane, slice(-TAIL, None)) for lane in lanes])
    ms = sim_step.last_ms
    t0 = time.perf_counter()
    sim_step(plain)
    plain_s = time.perf_counter() - t0
    err, nbytes = 0.0, 0
    fields = [f.name for f in dataclasses.fields(Metrics)]
    for (sp, tr), lane, ref, oi0, want in zip(cells, lanes, plain, head,
                                              golden, strict=True):
        name = f"{sp.name}/{tr['name']}"
        bad = [k for k, v in lane.st.items()
               if not torch.equal(v.cpu(), ref.st[k])]
        if bad:
            raise AssertionError(f"sim_step tail {name}: state differs "
                                 f"from the plain step in {bad}")
        oi, od, flags, _ = engine_torch.export(lane.S, lane.st)
        engine_torch.check_flags(flags)
        oi2, od2, _, _ = engine_torch.export(ref.S, ref.st)
        err = max(err, float(np.abs(oi - oi2).max()),
                  float(np.abs(od - od2).max()))
        row = engine_torch.metrics_from_outputs(sp, tr, oi, od).row()
        if any(row[k] != want[k] for k in fields):
            raise AssertionError(f"sim_step head + tail {name}: differs "
                                 f"from the golden row")
        nbytes += engine_torch.step_bytes(lane.S, TAIL, oi - oi0)
    probes = sum(int(lane.st["probes"][0]) for lane in lanes)
    log(f"sim_step tail 12 lanes x last {TAIL} of scale 1.0: every state "
        f"array equal to the plain step; head + tail equal to the golden "
        f"rows; kernel_ms={ms} plain_s(cpu)={plain_s} probes={probes} "
        f"bytes={nbytes}")
    res["tail"] = {"ms": ms, "plain_ms": plain_s * 1e3, "max_abs_err": err,
                   "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    del lanes, plain
    torch.cuda.empty_cache()


def phase_main(res: dict) -> None:
    from repro_torch import cli
    from repro_torch.core import engine_torch
    from repro_torch.core.metrics import Metrics
    from repro_torch.kernels.sim_step import sim_step
    from repro_torch.kernels.tag_probe import tag_probe
    import dataclasses
    golden = json.loads((ROOT / "src/repro_torch/data/table_scale1.json")
                        .read_text())
    # the main path's counts: zero just before, read just after
    sim_step.launches = 0
    tag_probe.launches = 0
    t0 = time.perf_counter()
    art = cli.run_table(1.0, device="cuda")
    wall = time.perf_counter() - t0
    launches = sim_step.launches
    probe_launches = tag_probe.launches
    stats = dict(engine_torch.last_run_stats)
    if launches < 1 or stats["tag_probe_main_path_probes"] <= 0:
        raise AssertionError(f"main path did not run the kernels: "
                             f"sim_step launches={launches} stats={stats}")
    fields = [f.name for f in dataclasses.fields(Metrics)]
    for got, want in zip(art["rows"], golden, strict=True):
        bad = {k: (got[k], want[k]) for k in fields if got[k] != want[k]}
        if bad:
            raise AssertionError(f"{want['name']}/{want['workload']}: "
                                 f"differs from golden: {bad}")
    if art["result"].get("trend_ok") is not True:
        raise AssertionError("trend verdict is not true at scale 1.0")
    nbytes = stats["step_bytes"]
    n_acc = stats["accesses"]
    log(f"main path: 12 cells equal to golden rows; trend_ok=True "
        f"wall_s={wall} host_prep_s={stats['host_prep_s']} "
        f"kernel_ms={stats['kernel_ms']} sim_step_launches={launches} "
        f"tag_probe_launches={probe_launches} "
        f"tag_probe_main_path_probes={stats['tag_probe_main_path_probes']} "
        f"accesses={n_acc} bytes={nbytes}")
    res["main"] = {"wall_s": wall, "kernel_ms": stats["kernel_ms"],
                   "launches": launches,
                   "probe_launches": probe_launches,
                   "probes": stats["tag_probe_main_path_probes"],
                   "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                   "accesses": n_acc}


def phase_batch(res: dict) -> None:
    import numpy as np
    import torch
    from repro_torch.core import engine_torch
    from repro_torch.core import trace as trace_mod
    from repro_torch.core.presets import CONFIGS
    tr = trace_mod.WORKLOADS["cnn"](0.05)
    single = [engine_torch.run_single(sp, tr, device="cuda")
              for sp in CONFIGS]
    sps = [sp for sp in CONFIGS for _ in range(64)]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    outs = engine_torch.run_batch(sps, tr, device="cuda")
    wall = time.perf_counter() - t0
    stats = dict(engine_torch.last_run_stats)
    peak = torch.cuda.max_memory_allocated()
    for i, (oi, od) in enumerate(outs):
        oi1, od1 = single[i // 64]
        if not (np.array_equal(oi, oi1) and np.array_equal(od, od1)):
            raise AssertionError(f"batch lane {i} != single-lane "
                                 f"{sps[i].name}")
    kernel_s = stats["kernel_ms"] / 1e3
    n = len(tr["core"])
    log(f"batch: 256 lanes equal to their single-lane runs; "
        f"kernel_ms={stats['kernel_ms']} wall_s={wall} "
        f"host_prep_s={stats['host_prep_s']} "
        f"configs_per_s={256 / kernel_s} accesses_per_s={256 * n / kernel_s} "
        f"wall_configs_per_s={256 / wall} max_memory_allocated={peak}")
    res["batch"] = {"kernel_ms": stats["kernel_ms"], "wall_s": wall,
                    "peak_bytes": peak}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import trace as trace_mod
    from repro_torch.kernels import _lib

    res: dict = {}
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    log("== phase 1: card ==")
    log(f"device: {name} (count {count}) torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(smi)
    log("== phase 2: build ==")
    t0 = time.perf_counter()
    _lib.build(["tag_probe", "sim_step"])
    log(f"build wall_s={time.perf_counter() - t0}")
    for lib, info in _lib.build_info.items():
        log(f"  {lib}: nvcc_s={info['seconds']}")
        for line in info["log"].splitlines():
            if any(k in line for k in ("registers", "stack", "spill")):
                log(f"    ptxas: {line.strip()}")
    log("== phase 3: tag_probe vs plain ==")
    phase_tag_probe(res)
    traces = {wl: gen(1.0) for wl, gen in trace_mod.WORKLOADS.items()}
    log("== phase 4: sim_step vs plain step, 1000-access prefixes ==")
    phase_step(res, traces)
    log(f"== phase 4b: sim_step vs plain step, last {TAIL} accesses "
        f"at scale 1.0 ==")
    phase_tail(res, traces)
    log("== phase 5: main path (table, scale 1.0) ==")
    phase_main(res)
    log("== phase 6: 256-lane batch (scale 0.05) ==")
    phase_batch(res)

    tp, m, pre, tail = (res[k] for k in ("tag_probe", "main", "step",
                                         "tail"))
    kernels = [{
        "name": "tag_probe", "route": "cuda",
        "source": "src/repro_torch/csrc/tag_probe.cu",
        "replaces": "src/repro/kernels/tag_probe.py:32",
        "launches": m["probe_launches"],
        # the main path runs the probe as a routine of the step kernel
        "runs_inside": "sim_step",
        "main_path_probes": m["probes"],
        "shape": f"B={tp[0]['B']} A={tp[0]['A']}",
        "max_abs_err": max(e["max_abs_err"] for e in tp),
        "ms": tp[0]["ms"], "plain_ms": tp[0]["plain_ms"],
        "bound_ms": tp[0]["bound_ms"], "bound_by": "bytes",
        "library_ms": None,
        "A16": {k: tp[1][k] for k in ("ms", "plain_ms", "bound_ms")},
    }, {
        "name": "sim_step", "route": "cuda",
        "source": "src/repro_torch/csrc/sim_step.cu",
        "replaces": "src/repro/core/engine_jax.py:1383",
        "launches": m["launches"],
        # ms / plain_ms / bound_ms: the long-run window of phase 4b
        "shape": f"12 lanes x last {TAIL} accesses of scale 1.0",
        "max_abs_err": max(tail["max_abs_err"], pre["max_abs_err"]),
        "ms": tail["ms"], "plain_ms": tail["plain_ms"],
        "bound_ms": tail["bound_ms"], "bound_by": "bytes",
        "library_ms": None,
        "prefix_ms": pre["ms"], "prefix_plain_ms": pre["plain_ms"],
        "main_path_shape": f"12 lanes, {m['accesses']} accesses",
        "main_path_ms": m["kernel_ms"],
        "main_path_bound_ms": m["bound_ms"],
    }]
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
