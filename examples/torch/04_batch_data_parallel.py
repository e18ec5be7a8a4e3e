#!/usr/bin/env python
"""Multi-clip batch with the PyTorch port, sharded per clip over the ranks
of a process group.

Each rank drives one card and stabilizes its share of the clips; every
rank gets the whole batch back (``parallel/dp.py``). Run alone it is a
world of one; under torchrun each process takes a card:

    python examples/torch/04_batch_data_parallel.py [--device cpu]
    torchrun --nproc-per-node 4 examples/torch/04_batch_data_parallel.py
"""
import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--clips", type=int, default=8)
    args = ap.parse_args()

    import numpy as np
    import torch
    import torch.distributed as dist

    from dvsg_tpu_torch.config import StabilizeConfig
    from dvsg_tpu_torch.parallel import dp
    from dvsg_tpu_torch.parallel import mesh as mesh_lib
    from dvsg_tpu_torch.train.synthetic import synthetic_clip_u8
    from dvsg_tpu_torch.utils.checkpoint import load_npz

    # A process group from torchrun's environment, or none for one process.
    mesh_lib.init_distributed(device=args.device)
    try:
        mesh = mesh_lib.make_mesh(device=args.device)
        params, mcfg = load_npz(os.path.join(ROOT, "checkpoints",
                                             "flagship_fast.npz"))
        cfg = StabilizeConfig(model=mcfg, chunk_frames=4)

        # Clips in one batch share a resolution; mixed resolutions go in
        # separate batches (see serve.py's grouping).
        clips = np.stack([
            synthetic_clip_u8(torch.Generator().manual_seed(i), 8, 120,
                              160)[0].numpy() for i in range(args.clips)])
        out = dp.ShardedClipStabilizer(cfg, params, mesh
                                       ).stabilize_clips(clips)
        if mesh_lib.world_rank() == 0:
            print(f"stabilized {out.shape[0]} clips x {out.shape[1]} frames "
                  f"on {mesh.size} rank(s) of {mesh.device.type}: "
                  f"{out.shape}, {out.dtype}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
