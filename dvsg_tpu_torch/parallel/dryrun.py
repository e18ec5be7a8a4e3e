"""A dry run of every multi-rank surface, and the process spawner it uses.

``dryrun_multichip(n)`` runs, over n ranks on tiny shapes, one data-
parallel training step, clip-sharded stabilization (plain, causal, lag)
and a temporally sharded clip (plain, causal), and holds each against the
same work in one process: the training step within 1e-5 (loss) and 1e-6
(parameters), every frame byte for byte. With n cards it runs one NCCL
rank per card; with fewer it spawns n gloo ranks on the CPU and says so.

    python -m dvsg_tpu_torch.parallel.dryrun 4
"""

from __future__ import annotations

import os
import sys
import tempfile
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp


def join_group(rank: int, world: int, store_path: str,
               backend: str = "gloo", timeout_s: float = 120.0) -> None:
    """Join a process group of ``world`` ranks over a file store at
    ``store_path`` (no TCP port to collide with other runs); a collective
    that waits longer than ``timeout_s`` raises. The ranks run on this
    host, so ``rank`` is also this process's ``LOCAL_RANK``
    (``mesh.rank_device`` maps it to its card): a ``LOCAL_RANK`` inherited
    from the spawning process would put every rank on one card.

    A gloo group returns only when every rank has joined: gloo's
    ``init_process_group`` returns on a rank once its own side of each
    connection is up, and a rank that then leaves the group at once (a
    short case) closed a connection its peer was still handshaking on
    ("Gloo connectFullMesh failed ... Connection closed by peer"), a few
    times in a hundred groups on a loaded host. NCCL connects at its
    first collective, on the rank's card."""
    os.environ["LOCAL_RANK"] = str(rank)
    dist.init_process_group(backend, init_method=f"file://{store_path}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=timeout_s))
    if backend == "gloo":
        dist.barrier()


def run_ranks(fn, n: int, args=(), timeout_s: float = 300.0) -> None:
    """Run ``fn(rank, *args)`` in ``n`` fresh processes (the ``spawn``
    start method: the caller may hold CUDA or threads) and wait for all of
    them. Raises if a rank raises, and kills every rank and raises
    ``TimeoutError`` after ``timeout_s``: a hung collective fails instead
    of hanging the caller."""
    ctx = tmp.start_processes(fn, args=args, nprocs=n, join=False,
                              start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{n} ranks did not finish in "
                                   f"{timeout_s:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)


def tiny_setup():
    """(ModelConfig, params) of the dry run: a small model whose head moves
    pixels, made from a seed."""
    from dvsg_tpu_torch.config import ModelConfig
    from dvsg_tpu_torch.models import motion_cnn
    mcfg = ModelConfig(window=3, model_size=(32, 32), grid_size=(8, 8),
                       base_features=8, blocks_per_level=1)
    gen = torch.Generator().manual_seed(0)
    params = motion_cnn.init_params(mcfg, gen)
    params["head_out.weight"] = 0.05 * torch.randn(
        params["head_out.weight"].shape, generator=gen)
    return mcfg, params


def _check_equal(name: str, got: np.ndarray, want: np.ndarray) -> None:
    if got.shape != want.shape or not np.array_equal(got, want):
        n = (int((got != want).sum()) if got.shape == want.shape
             else f"shape {got.shape} vs {want.shape}")
        raise AssertionError(f"{name}: differs from one process ({n})")


def _dryrun_rank(rank: int, n: int, store_path: str, backend: str,
                 device: str) -> None:
    from dvsg_tpu_torch.config import StabilizeConfig, TrainConfig
    from dvsg_tpu_torch.parallel import dp
    from dvsg_tpu_torch.parallel import mesh as mesh_lib
    from dvsg_tpu_torch.parallel.temporal import TemporalShardedStabilizer
    from dvsg_tpu_torch.pipeline.stabilize import Stabilizer
    from dvsg_tpu_torch.train import loop

    if device == "cpu":
        torch.set_num_threads(1)
    join_group(rank, n, store_path, backend)
    try:
        mesh = mesh_lib.make_mesh(device=device)
        dev = mesh.device
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        mcfg, params = tiny_setup()

        # One data-parallel training step against the same step in one
        # process.
        tcfg = TrainConfig(model=mcfg, batch_size=2 * n, steps=10,
                           warmup_steps=1, learning_rate=1e-3)
        gen = torch.Generator().manual_seed(1)
        one = loop.init_state(tcfg, gen, dev)
        gen = torch.Generator().manual_seed(1)
        state = dp.replicate_state(loop.init_state(tcfg, gen, dev), mesh)
        step_fn, shard_batch = dp.make_dp_train_step(tcfg, mesh)
        for step in range(2):
            want = loop.train_step(one, loop.step_generator(0, step), tcfg)
            got = step_fn(state, shard_batch(loop.step_generator(0, step)))
            np.testing.assert_allclose(float(got["total"]),
                                       float(want["total"]), rtol=1e-5)
        for (k, a), b in zip(one.params.items(), state.params.values()):
            np.testing.assert_allclose(b.cpu().numpy(), a.cpu().numpy(),
                                       atol=1e-6, err_msg=k)

        # Clip-sharded stabilization, plain, causal and lag.
        clips = np.random.default_rng(1).integers(
            0, 256, (n, 6, 32, 40, 3), dtype=np.uint8)
        base = StabilizeConfig(model=mcfg, chunk_frames=4)
        for mode, kw in (("plain", {}), ("causal", dict(path_smooth=8)),
                         ("lag", dict(path_smooth=8, path_smooth_lag=2))):
            cfg = base.replace(**kw)
            out = dp.ShardedClipStabilizer(cfg, params, mesh
                                           ).stabilize_clips(clips)
            single = Stabilizer(cfg, params, device=dev)
            for i in range(n):
                _check_equal(f"sharded {mode} clip {i}", out[i],
                             single.stabilize_clip(clips[i]))

        # One clip with the frame axis sharded, plain and causal (a
        # partial last chunk included).
        clip = np.random.default_rng(2).integers(
            0, 256, (5 * n, 32, 40, 3), dtype=np.uint8)
        for mode, kw in (("plain", {}), ("causal", dict(path_smooth=8))):
            cfg = base.replace(chunk_frames=2 * n, **kw)
            out = TemporalShardedStabilizer(cfg, params, mesh
                                            ).stabilize_clip(clip)
            _check_equal(f"temporal {mode}", out,
                         Stabilizer(cfg, params, device=dev
                                    ).stabilize_clip(clip))
        devices = mesh_lib.all_gather_object(mesh, str(dev))
        if dev.type == "cuda" and len(set(devices)) != n:
            raise AssertionError(f"ranks share a card: {devices}")
        if rank == 0:
            print(f"dryrun_multichip: {n} {backend} ranks on "
                  f"{', '.join(devices)}: DP train step, sharded clips "
                  "(plain, causal, lag) and a temporal clip (plain, causal) "
                  "== one process", flush=True)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n: int, timeout_s: float = 600.0) -> None:
    """Every multi-rank surface over ``n`` ranks, each against one process
    (module docstring). Raises on any difference."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards >= n:
        backend, device = "nccl", "cuda"
    else:
        backend, device = "gloo", "cpu"
        print(f"dryrun_multichip: {cards} card(s) for {n} ranks; spawning "
              f"{n} gloo ranks on the CPU", flush=True)
    with tempfile.TemporaryDirectory() as d:
        run_ranks(_dryrun_rank, n,
                  args=(n, os.path.join(d, "store"), backend, device),
                  timeout_s=timeout_s)


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
    print("dryrun_multichip ok")
