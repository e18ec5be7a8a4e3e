"""One run of one cell: the manifest, the cell's files, the ranks, the
metrics and the result line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file found by its name:

* ``BENCHMARK.json`` at the checkout's root names the cells, metrics and
  configurations;
* ``portbench/configs/<config>.json`` is the model configuration;
* ``portbench/traffic/<mix>.json`` is the traffic: its ``kind`` names the
  driver ``portbench/drivers/<kind>.py`` that generates and runs it, its
  ``ranks`` the processes (one a card) the cell runs in;
* ``portbench/limits/<cell>.json`` holds the limit of each number that
  decides ``correct``;
* ``portbench/metrics/<metric>.py`` reads one metric from a rank's
  ``Run``: ``read(run)`` returns a number, or None where it finds nothing
  to read, and ``MERGE`` ("max", "min" or "mean") combines the ranks.

A driver's ``run_rank(ctx)`` does one rank's set-up, window and check and
returns its ``Run``. With several ranks the harness spawns them, each
joins the process group, and each writes what it read to a file under
the run's temporary directory, which the harness merges.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import statistics
import sys
import tempfile
import time
from typing import Any, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# Whole top-level module names that no process of a run may load.
FORBIDDEN = ("jax", "jaxlib", "flax", "dvsg_tpu")
# Build and kernel caches of the program and of torch, at fixed paths in
# the checkout (the program's own nvcc builds go to build/dvsg_tpu_torch).
CACHE_DIRS = {"TRITON_CACHE_DIR": "build/portbench/triton",
              "TORCH_EXTENSIONS_DIR": "build/portbench/torch_extensions",
              "TORCHINDUCTOR_CACHE_DIR": "build/portbench/inductor",
              "CUDA_CACHE_PATH": "build/portbench/cuda"}


def prepare_env() -> None:
    """Caches in the checkout, JAX kept out of libraries that would load
    it, the checkout importable."""
    for key, rel in CACHE_DIRS.items():
        os.environ[key] = os.path.join(ROOT, rel)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def _json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Spec:
    """A cell and everything the manifest and its files say of it."""
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @property
    def name(self) -> str:
        return self.cell["name"]


def load_spec(workload: str) -> Spec:
    manifest = _json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {c["name"]: c for c in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the manifest has "
                         f"{sorted(cells)}")
    cell = cells[workload]
    conf = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    e2e = [m for m in manifest["end_to_end"]
           if workload in m.get("workloads", [workload])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in moved)]
    return Spec(cell, _json(os.path.join(ROOT, conf["file"])),
                _json(os.path.join(BENCH_DIR, "traffic",
                                   cell["traffic"] + ".json")),
                _json(os.path.join(BENCH_DIR, "limits", workload + ".json")),
                e2e, layer)


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(BENCH_DIR, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Ctx:
    """What a driver's rank is given."""
    spec: Spec
    seed: int
    seconds: float
    trace: bool
    device: Any                 # torch.device of this rank
    rank: int = 0
    world: int = 1
    t_start: float = 0.0        # time.monotonic() when the run began
    fault: Optional[str] = None  # a fault planted in the timed path
    parts: dict = dataclasses.field(default_factory=dict)

    def part(self, name: str, seconds: float) -> None:
        self.parts[name] = self.parts.get(name, 0.0) + seconds


@dataclasses.dataclass
class Run:
    """One rank's reading of a run, for the metric readers."""
    spec: Spec
    rank: int
    world: int
    setup_s: float
    window_s: float
    work: dict                  # counts of the window's work
    stamps: dict                # host-clock samples (e.g. latencies, ms)
    stages: dict                # the program's StageTimer, by stage
    checks: dict                # number compared -> value
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: Any = None           # tracing.Trace of a traced run

    @property
    def model(self) -> dict:
        return self.spec.config["model"]


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def start_device(ctx: Ctx) -> None:
    """The rank's CUDA context and the traffic's kernels, built with nvcc
    on a checkout's first run and loaded after; timed as set-up parts."""
    import torch
    from dvsg_tpu_torch.ops import _build
    if ctx.device.type != "cuda":
        return
    t = time.monotonic()
    torch.cuda.init()
    torch.empty(1, device=ctx.device)
    ctx.part("cuda_context", time.monotonic() - t)
    t = time.monotonic()
    _build.build(ctx.spec.traffic["kernels"])
    ctx.part("kernels", time.monotonic() - t)


def read_metrics(run: Run, metrics: list) -> dict:
    out = {}
    for m in metrics:
        value = load_module("metrics", m["name"]).read(run)
        if value is not None:
            out[m["name"]] = float(value)
    return out


def rank_result(run: Run, ctx: Ctx) -> dict:
    """What one rank reports: its metrics, checks and device readings."""
    res = {"e2e": read_metrics(run, ctx.spec.end_to_end),
           "layer": read_metrics(run, ctx.spec.per_layer) if ctx.trace
           else {},
           "checks": run.checks, "attempted": run.attempted,
           "failed": run.failed, "memory_peak_bytes": run.memory_peak_bytes,
           "parts": ctx.parts, "forbidden": forbidden_modules()}
    if run.trace is not None:
        res.update(busy_s=run.trace.busy_s(), window_s=run.trace.window_s,
                   breakdown={"device_ops": run.trace.top_ops(10),
                              "idle_gaps": run.trace.idle_gaps(10)})
    return res


def merge(results: list) -> dict:
    """One result from the ranks' results."""
    first = results[0]
    out = dict(first)

    def combine(name: str, values: list):
        how = getattr(load_module("metrics", name), "MERGE", "max")
        return {"max": max, "min": min,
                "mean": statistics.fmean}[how](values)

    for key in ("e2e", "layer"):
        out[key] = {name: combine(name, [r[key][name] for r in results
                                         if name in r[key]])
                    for name in first[key]}
    out["checks"] = {k: max(r["checks"][k] for r in results)
                     for k in first["checks"]}
    out["memory_peak_bytes"] = max(r["memory_peak_bytes"] for r in results)
    out["forbidden"] = sorted({m for r in results for m in r["forbidden"]})
    if "busy_s" in first:
        out["busy_s"] = statistics.fmean(r["busy_s"] for r in results)
        out["window_s"] = statistics.fmean(r["window_s"] for r in results)
    out["parts"] = {k: max(r["parts"].get(k, 0.0) for r in results)
                    for k in first["parts"]}
    return out


def _rank_main(rank: int, world: int, store: str, out_dir: str,
               spec: Spec, args: dict) -> None:
    """A spawned rank: join the group, run the driver, write the result."""
    prepare_env()
    import torch
    import torch.distributed as dist
    from datetime import timedelta

    os.environ["LOCAL_RANK"] = str(rank)
    cuda = args["device"] == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(1)
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=300))
    try:
        dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
        ctx = Ctx(spec, args["seed"], args["seconds"], args["trace"], dev,
                  rank, world, args["t_start"], args.get("fault"))
        driver = load_module("drivers", spec.traffic["kind"])
        if args.get("sweep"):
            res = driver.sweep(ctx, args["sweep"])
        else:
            res = rank_result(driver.run_rank(ctx), ctx)
        tmp = os.path.join(out_dir, f"rank{rank}.json.tmp")
        with open(tmp, "w") as f:
            json.dump(res, f)
        os.replace(tmp, os.path.join(out_dir, f"rank{rank}.json"))
    finally:
        dist.destroy_process_group()


def run_ranks(spec: Spec, args: dict, world: int,
              timeout_s: float = 330.0) -> list:
    """Spawn ``world`` ranks (one a card), wait for all, and return their
    results in rank order. A rank that fails or outlives the timeout ends
    the run: every rank is stopped and waited for."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, os.path.join(tmp, "store"),
                                   tmp, spec, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            while any(p.is_alive() for p in procs):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks did not end in "
                                       f"{timeout_s:.0f} s")
                if any(p.exitcode not in (None, 0) for p in procs):
                    bad = [r for r, p in enumerate(procs)
                           if p.exitcode not in (None, 0)]
                    raise RuntimeError(f"rank(s) {bad} failed")
                time.sleep(0.05)
            bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
            if bad:
                raise RuntimeError(f"rank(s) {bad} failed")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(30)
        return [_json(os.path.join(tmp, f"rank{r}.json"))
                for r in range(world)]


def run_cell(spec: Spec, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, fault: Optional[str] = None
             ) -> dict:
    """Run the cell on ``device`` ("cuda" or "cpu"); the merged result."""
    world = int(spec.traffic.get("ranks", 1))
    if world > 1:
        args = {"seed": seed, "seconds": seconds, "trace": trace,
                "device": device, "t_start": t_start, "fault": fault}
        return merge(run_ranks(spec, args, world))
    import torch
    dev = torch.device("cuda", 0) if device == "cuda" else torch.device(
        "cpu")
    ctx = Ctx(spec, seed, seconds, trace, dev, 0, 1, t_start, fault)
    run = load_module("drivers", spec.traffic["kind"]).run_rank(ctx)
    return rank_result(run, ctx)


def correct(result: dict, spec: Spec) -> bool:
    """Every number compared is there and within its limit."""
    return all(k in result["checks"] and result["checks"][k] <= v["limit"]
               for k, v in spec.limits.items())


def result_line(result: dict, spec: Spec, device: dict) -> dict:
    units = {m["name"]: m["unit"] for m in spec.end_to_end + spec.per_layer}
    metrics = result["layer"] if "busy_s" in result else result["e2e"]
    line = {"correct": correct(result, spec),
            "attempted": result["attempted"], "failed": result["failed"],
            "metrics": {k: {"value": v, "unit": units[k]}
                        for k, v in metrics.items()},
            "device": dict(device,
                           memory_peak_bytes=result["memory_peak_bytes"])}
    if "busy_s" in result:
        line["device"].update(busy_s=result["busy_s"],
                              window_s=result["window_s"])
        line["breakdown"] = result["breakdown"]
    line["checks"] = {k: {"value": result["checks"].get(k),
                          "limit": spec.limits[k]["limit"]}
                      for k in spec.limits}
    return line


def run_sweep(spec: Spec, seeds: list, device: str) -> list:
    """The driver's ``sweep`` over ``seeds``: per seed, the numbers compared
    for the program, the control and each fault; over several ranks the
    worst rank's."""
    world = int(spec.traffic.get("ranks", 1))
    if world == 1:
        import torch
        dev = torch.device("cuda", 0) if device == "cuda" else \
            torch.device("cpu")
        ctx = Ctx(spec, seeds[0], 0.0, False, dev, 0, 1, time.monotonic())
        return load_module("drivers", spec.traffic["kind"]).sweep(ctx, seeds)
    args = {"seed": seeds[0], "seconds": 0.0, "trace": False,
            "device": device, "t_start": time.monotonic(), "sweep": seeds}
    ranks = run_ranks(spec, args, world, timeout_s=3000.0)
    out = []
    for recs in zip(*ranks):
        rec = dict(recs[0])
        for key, val in rec.items():
            if isinstance(val, dict):
                rec[key] = {k: max(r[key][k] for r in recs) for k in val}
        out.append(rec)
    return out
