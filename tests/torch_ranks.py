"""Multi-rank cases of the port's parallel tests, run in spawned gloo ranks
on the CPU (parallel/dryrun.py::run_ranks).

``spawn(case, n, tmp_path, payload)`` starts ``n`` ranks over a file store
under ``tmp_path`` (never a TCP port: several test workers run at once),
hands each the pickled ``payload``, runs ``CASES[case](rank, payload)`` and
returns every rank's result in rank order. A rank that raises fails the
call; a hang is killed after the time limit. This module imports no JAX:
the ranks load it by name, and only torch belongs there.
"""

import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

from dvsg_tpu_torch.config import TrainConfig
from dvsg_tpu_torch.parallel import dp, dryrun
from dvsg_tpu_torch.parallel import mesh as mesh_lib
from dvsg_tpu_torch.parallel import temporal
from dvsg_tpu_torch.train import loop

MODES = {"plain": {}, "causal": dict(path_smooth=8),
         "lag": dict(path_smooth=8, path_smooth_lag=2)}
RANK_TIMEOUT_S = 120.0          # a collective that waits longer raises
SPAWN_TIMEOUT_S = 240.0         # the whole spawn


def _meshes():
    """The world's mesh and a mesh of its first two ranks."""
    world = mesh_lib.make_mesh(device="cpu")
    two = world if world.size == 2 else mesh_lib.make_mesh((2,),
                                                           device="cpu")
    return {str(world.size): world, "2": two}


def _refusal(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError("not refused")


def sharded_cases(rank, p):
    """ShardedClipStabilizer in every mode over 2 and n ranks, DP train
    steps over both meshes, and the refusals."""
    res = {}
    meshes = _meshes()
    res["mesh"] = {k: (m.shape, m.rank, m.backend, m.device.type)
                   for k, m in meshes.items()}
    for name, m in meshes.items():
        if m.rank is None:
            continue
        for mode, kw in MODES.items():
            cfg = p["cfg"].replace(**kw)
            res[f"{name}/{mode}"] = dp.ShardedClipStabilizer(
                cfg, p["params"], m).stabilize_clips(p["clips"])
        tcfg = p["tcfg"]
        state = loop.build_state(tcfg, p["tparams"], "cpu")
        state = dp.replicate_state(state, m)
        step_fn, _ = dp.make_dp_train_step(tcfg, m)
        rows = m.shard(tcfg.batch_size)
        losses = [float(step_fn(state, tuple(x[rows] for x in d))["total"])
                  for d in p["draws"]]
        res[f"{name}/dp"] = (losses, {k: v.numpy().copy()
                                      for k, v in state.params.items()})
        res[f"{name}/dp_spans"] = _dp_step_spans(tcfg, p["tparams"], m)
    world = meshes[max(meshes, key=int)]
    res["uneven"] = _refusal(lambda: dp.ShardedClipStabilizer(
        p["cfg"], p["params"], world).stabilize_clips(
            p["clips"][:world.size + 2]))
    res["dp_batch"] = _refusal(lambda: dp.make_dp_train_step(
        TrainConfig(model=p["tcfg"].model, batch_size=world.size + 2),
        world))
    return res


def _dp_step_spans(tcfg, tparams, m) -> dict:
    """The program's spans in a profile of one DP step, drawn by
    ``shard_batch`` as a training run draws it: {name: count}."""
    from torch.profiler import ProfilerActivity, profile
    state = dp.replicate_state(loop.build_state(tcfg, tparams, "cpu"), m)
    step_fn, shard_batch = dp.make_dp_train_step(tcfg, m)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step_fn(state, shard_batch(loop.step_generator(0, 0)))
    counts: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("dvsg."):
            counts[e.name()] = counts.get(e.name(), 0) + 1
    return counts


def temporal_cases(rank, p):
    """TemporalShardedStabilizer over 2 and n ranks: plain and causal on a
    clip with a partial last chunk, strength 0, and the refusals."""
    res = {}
    for name, m in _meshes().items():
        if m.rank is None:
            continue
        for mode in ("plain", "causal"):
            cfg = p["cfg"].replace(chunk_frames=2 * m.size, **MODES[mode])
            res[f"{name}/{mode}"] = temporal.TemporalShardedStabilizer(
                cfg, p["params"], m).stabilize_clip(p["clip"])
        res[f"{name}/strength0"] = temporal.TemporalShardedStabilizer(
            p["cfg"].replace(chunk_frames=2 * m.size, strength=0.0),
            p["params"], m).stabilize_clip(p["clip"])
        res[f"{name}/lag"] = _refusal(
            lambda: temporal.TemporalShardedStabilizer(
                p["cfg"].replace(chunk_frames=2 * m.size, **MODES["lag"]),
                p["params"], m))
        res[f"{name}/indivisible"] = _refusal(
            lambda: temporal.TemporalShardedStabilizer(
                p["cfg"].replace(chunk_frames=2 * m.size + 1), p["params"],
                m))
        res[f"{name}/short"] = _refusal(
            lambda: temporal.TemporalShardedStabilizer(
                p["cfg"].replace(chunk_frames=m.size), p["params"], m))
    return res


class MemReader:
    def __init__(self, frames):
        self.frames, self.pos = frames, 0
        self.height, self.width = frames.shape[1:3]

    def read_batch(self, n):
        out = self.frames[self.pos:self.pos + n]
        self.pos += len(out)
        return out


class MemWriter:
    def __init__(self):
        self.parts = []

    def write_batch(self, frames):
        self.parts.append(np.array(frames))

    @property
    def frames(self):
        return np.concatenate(self.parts) if self.parts else None


def multi_cases(rank, p):
    """stabilize_multi(mesh=) over the world, and the CLI's
    stabilize-batch as torchrun would start it on every rank."""
    from dvsg_tpu_torch import cli
    from dvsg_tpu_torch.pipeline.multiclip import stabilize_multi
    m = mesh_lib.make_mesh(device="cpu")
    res = {}
    for mode in ("plain", "causal"):
        writers = [MemWriter() for _ in p["clips"]]
        r = stabilize_multi(p["cfg"].replace(**MODES[mode]), p["params"],
                            [MemReader(c) for c in p["clips"]], writers,
                            mesh=m)
        res[mode] = ([w.frames for w in writers], r.frames_written,
                     r.errors)
    res["cli"] = cli.main(p["argv"])
    # A batch artifact cut for the mesh: every rank exports its shard's
    # step, loads it and runs its shard; every rank gets the whole batch.
    from dvsg_tpu_torch import export as export_lib
    clips = np.stack([c[:4] for c in p["clips"]])
    path = os.path.join(p["dir"], f"batch{rank}.dvsgt")
    export_lib.save_exported(export_lib.export_batch_program(
        p["cfg"], p["params"], len(clips), *clips.shape[2:4], mesh=m),
        path, p["cfg"])
    loaded = export_lib.load_exported(path, mesh=m)
    res["artifact"] = (loaded.meta["nr_devices"], loaded.n_clips,
                       loaded.stabilize_clips(clips))
    return res


def tp_cases(rank, p):
    """Tensor parallelism on each mesh shape of ``p["shapes"]`` that the
    world holds (axes ("data", "model")), on ``p["device"]`` (default the
    CPU): the sharding spec, offsets of a batch of windows (the data axis
    takes its rows), a clip through the TP chunk step, and a clip batch
    over the data axis."""
    from dvsg_tpu_torch.models import motion_cnn
    from dvsg_tpu_torch.parallel import tp
    from dvsg_tpu_torch.pipeline.stabilize import build_model
    res = {}
    dev = torch.device(p.get("device", "cpu"))
    for shape in p["shapes"]:
        m = mesh_lib.make_mesh(shape, axis_names=("data", "model"),
                               device=dev)
        if m.rank is None:
            continue
        key = "x".join(map(str, shape))
        model = build_model(p["cfg"].model, p["params"], dev)
        sharded = tp.tp_model(model, m)
        rows = m.along("data").shard(len(p["windows"]))
        with torch.inference_mode():
            offs = motion_cnn.predict_offsets(
                sharded, torch.from_numpy(p["windows"][rows]).to(dev)).cpu()
        stab = tp.TPStabilizer(p["cfg"], p["params"], m)
        res[key] = {
            "spec": mesh_lib.tp_param_sharding(m, p["params"]),
            "rows": rows, "offsets": offs.numpy(),
            "coords": (m.along("data").rank, m.along("model").rank),
            "clip": stab.stabilize_clip(p["clip"]),
            "clips": stab.stabilize_clips(p["clips"])}
    return res


def local_cases(rank, p):
    """The card index this rank would drive (``LOCAL_RANK``)."""
    return {"local": mesh_lib._local_index(),
            "env": os.environ.get("LOCAL_RANK")}


def dp_twice_cases(rank, p):
    """Two runs of the same data-parallel steps from the same state over
    the world: every loss and the parameters' bytes after each run."""
    m = mesh_lib.make_mesh(device=p.get("device", "cpu"))
    runs = []
    for _ in range(2):
        state = dp.replicate_state(
            loop.build_state(p["tcfg"], p["tparams"], m.device), m)
        step_fn, shard_batch = dp.make_dp_train_step(p["tcfg"], m)
        losses = [float(step_fn(state, shard_batch(
            loop.step_generator(0, i)))["total"])
            for i in range(p["steps"])]
        runs.append((losses, b"".join(
            v.detach().cpu().numpy().tobytes()
            for v in state.params.values())))
    return runs


def nccl_cases(rank, p):
    """Over NCCL, one rank a card (``rank_device``), the current device
    left as the process started: the temporal ring exchange (plain and
    causal), the DP steps and ``all_gather_object``."""
    m = mesh_lib.make_mesh(device="cuda")
    res = {"device": str(m.device), "backend": m.backend,
           "objects": mesh_lib.all_gather_object(m, (rank, str(m.device)))}
    for mode in ("plain", "causal"):
        cfg = p["cfg"].replace(**MODES[mode])
        res[mode] = temporal.TemporalShardedStabilizer(
            cfg, p["params"], m).stabilize_clip(p["clip"])
    torch.backends.cudnn.deterministic = True
    res["dp"] = dp_twice_cases(rank, dict(p, device="cuda"))
    return res


CASES = {"sharded": sharded_cases, "temporal": temporal_cases,
         "multi": multi_cases, "tp": tp_cases, "local": local_cases,
         "dp_twice": dp_twice_cases, "nccl": nccl_cases}


def _rank(rank, n, store, case, payload_path, out_dir, backend="gloo"):
    torch.set_num_threads(1)
    dryrun.join_group(rank, n, store, backend, timeout_s=RANK_TIMEOUT_S)
    try:
        with open(payload_path, "rb") as f:
            payload = pickle.load(f)
        res = CASES[case](rank, payload)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def spawn(case, n, tmp_path, payload, backend="gloo"):
    """Every rank's result of ``CASES[case]`` over ``n`` ranks of a
    ``backend`` group."""
    d = str(tmp_path)
    os.makedirs(d, exist_ok=True)
    payload_path = os.path.join(d, "payload.pkl")
    with open(payload_path, "wb") as f:
        pickle.dump(payload, f)
    dryrun.run_ranks(_rank, n, args=(n, os.path.join(d, "store"), case,
                                     payload_path, d, backend),
                     timeout_s=SPAWN_TIMEOUT_S)
    out = []
    for r in range(n):
        with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out
