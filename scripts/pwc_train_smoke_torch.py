"""A short training run of the ``pwc`` arch (PWC-Net as the motion
estimator) on one card: the ``train_b32`` recipe's first steps from the
seeded weights of ``portbench/reference/pwc.py::init``, each step's loss
held to the plain reference's (``reference/pwc.py::loss`` in
``reference/train.py``'s steps), then a few timed steps and the peak
memory. Prints one JSON line.

    python3 scripts/pwc_train_smoke_torch.py [--seed N] [--timed 5]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=2323000001)
    p.add_argument("--checked", type=int, default=3)
    p.add_argument("--timed", type=int, default=5)
    args = p.parse_args(argv)

    import torch
    from dvsg_tpu_torch.config import TrainConfig, model_config_from_dict
    from dvsg_tpu_torch.train import loop
    from portbench import generate
    from portbench.reference import pwc
    from portbench.reference import train as ref_train

    with open(os.path.join(ROOT, "portbench", "configs", "pwc.json")) as f:
        model = json.load(f)["model"]
    with open(os.path.join(ROOT, "portbench", "traffic",
                           "train_b32.json")) as f:
        traffic = json.load(f)
    w = traffic["loss_weights"]
    tcfg = TrainConfig(
        model=model_config_from_dict(model),
        batch_size=traffic["batch_size"],
        learning_rate=traffic["learning_rate"],
        weight_decay=traffic["weight_decay"], steps=traffic["steps"],
        warmup_steps=traffic["warmup_steps"], pixel_weight=w["pixel"],
        offset_weight=w["offset"], smooth_weight=w["smooth"],
        reg_weight=w["reg"], checkpoint_every=0)
    dev = torch.device("cuda")
    params = pwc.init(model, args.seed)
    state = loop.build_state(tcfg, params, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    losses = []
    for k in range(args.checked):
        aux = loop.train_step(state, generate.step_generator(args.seed, k),
                              tcfg)
        losses.append(float(aux["total"]))
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for k in range(args.checked, args.checked + args.timed):
        loop.train_step(state, generate.step_generator(args.seed, k), tcfg)
    torch.cuda.synchronize(dev)
    step_s = (time.perf_counter() - t0) / max(args.timed, 1)
    peak = torch.cuda.max_memory_allocated(dev)
    del state
    torch.cuda.empty_cache()

    ref_train.loss = pwc.loss          # the reference's steps, pwc's loss
    train = {k: traffic[k] for k in ("batch_size", "learning_rate", "steps",
                                     "warmup_steps", "weight_decay",
                                     "loss_weights")}
    ref = ref_train.first_steps(
        {k: v.to(dev) for k, v in params.items()}, model, train,
        [generate.step_generator(args.seed, k) for k in range(args.checked)])
    gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"]))
    print(json.dumps({"seed": args.seed, "losses": losses,
                      "ref_losses": ref["losses"], "loss_gap": gap,
                      "step_s": step_s, "samples_per_s":
                      tcfg.batch_size / step_s, "memory_peak_bytes": peak,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
