"""Training steps on one card (``train/loop.py::train_step``) or data-
parallel over ``ranks`` cards (``parallel/dp.py::make_dp_train_step``:
every rank draws the whole batch with ``shard_batch``, renders and
differentiates its rows, and all-reduces the gradients in ``step_fn``).

Set-up builds the one training state from the checkpoint's weights (the
committed weights: a fine-tuning run, whose first steps already move
every layer) with a fresh AdamW on the recipe's schedule, and drives it
through its first ``CHECKED_STEPS`` steps, reading what ``correct``
compares: each step's loss, each parameter's first gradient as AdamW
holds it (its first moment over 1 - beta1), and each parameter's change
over those steps. More steps warm it up and time it; the window then runs
as many steps as fill ``seconds``, with no synchronize between them. Step
k draws its batch from a CPU generator seeded by (seed, k).

``correct``: the plain reference (``portbench/reference/train.py``)
works the same steps out again from the checkpoint file and the same
generators. ``loss_gap`` is the largest relative gap of a step's loss;
``grad_gap`` and ``change_gap`` the largest gap of one parameter's norm,
over the larger of the reference's norm of that parameter and of the
median parameter. The change leaves out parameters whose reference
gradient is under a thousandth of the median parameter's: Adam moves
those by round-off alone.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time

import torch

from portbench import generate, harness, tracing

# Steps that ``correct`` compares, then steps that warm the state up, then
# steps timed to size the window.
CHECKED_STEPS = 3
WARMUP_STEPS = 2
TIMED_STEPS = 3


def reference_train(spec) -> dict:
    """The training settings the reference needs, from the traffic file."""
    t = spec.traffic
    return {"batch_size": t["batch_size"],
            "learning_rate": t["learning_rate"], "steps": t["steps"],
            "warmup_steps": t["warmup_steps"],
            "weight_decay": t["weight_decay"],
            "loss_weights": t["loss_weights"]}


def compare(prog: dict, ref: dict) -> dict:
    losses = max(abs(a - b) / abs(b)
                 for a, b in zip(prog["losses"], ref["losses"]))
    g_ref = ref["grad"]
    g_med = statistics.median(g_ref.values())
    grad = max(abs(prog["grad"][k] - g) / max(g, g_med)
               for k, g in g_ref.items())
    moved = [k for k, g in g_ref.items() if g >= 1e-3 * g_med]
    c_ref = ref["change"]
    c_med = statistics.median(c_ref[k] for k in moved)
    change = max(abs(prog["change"][k] - c_ref[k]) / max(c_ref[k], c_med)
                 for k in moved)
    return {"loss_gap": losses, "grad_gap": grad, "change_gap": change}


def reference_readings(spec, device, seed: int, tf32: bool = False
                       ) -> dict:
    """The reference's readings of the first steps; with ``tf32`` computed
    with TF32 on (the control)."""
    from portbench.reference import cnn
    from portbench.reference import train as ref
    params, _ = cnn.load_npz(os.path.join(harness.ROOT,
                                          spec.config["checkpoint"]))
    params = {k: v.to(device) for k, v in params.items()}
    gens = [generate.step_generator(seed, k)
            for k in range(CHECKED_STEPS)]
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        return ref.first_steps(params, spec.config["model"],
                               reference_train(spec), gens)
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


class Trainer:
    """The program's training step on this rank, built once; ``fresh``
    gives a new state from the checkpoint's weights."""

    def __init__(self, ctx: harness.Ctx):
        t = time.monotonic()
        from dvsg_tpu_torch.config import TrainConfig, model_config_from_dict
        from dvsg_tpu_torch.parallel import dp
        from dvsg_tpu_torch.parallel import mesh as mesh_lib
        from dvsg_tpu_torch.train import loop
        from dvsg_tpu_torch.utils.checkpoint import load_npz
        self.dp, self.mesh_lib, self.loop = dp, mesh_lib, loop
        ctx.part("import_program", time.monotonic() - t)

        self.ctx, self.dev = ctx, ctx.device
        spec, traffic = ctx.spec, ctx.spec.traffic
        harness.start_device(ctx)

        t = time.monotonic()
        self.params, mcfg = load_npz(os.path.join(
            harness.ROOT, spec.config["checkpoint"]))
        if mcfg != model_config_from_dict(spec.config["model"]):
            raise ValueError(f"{spec.config['checkpoint']} holds {mcfg}, not "
                             f"the configuration's {spec.config['model']}")
        w = traffic["loss_weights"]
        self.tcfg = TrainConfig(
            model=mcfg, batch_size=traffic["batch_size"],
            learning_rate=traffic["learning_rate"],
            weight_decay=traffic["weight_decay"], steps=traffic["steps"],
            warmup_steps=traffic["warmup_steps"], pixel_weight=w["pixel"],
            offset_weight=w["offset"], smooth_weight=w["smooth"],
            reg_weight=w["reg"], checkpoint_every=0)
        self.mesh = (mesh_lib.make_mesh(device=self.dev.type)
                     if ctx.world > 1 else None)
        ctx.part("weights", time.monotonic() - t)

    def fresh(self):
        """(state, step): a new state and its step ``step(seed, k)``."""
        loop, tcfg = self.loop, self.tcfg
        state = loop.build_state(tcfg, self.params, self.dev)
        if self.mesh is None:
            def step(seed, k):
                return loop.train_step(
                    state, generate.step_generator(seed, k), tcfg)
            return state, step
        state = self.dp.replicate_state(state, self.mesh)
        step_fn, shard_batch = self.dp.make_dp_train_step(tcfg, self.mesh)

        def step(seed, k):
            return step_fn(state, shard_batch(
                generate.step_generator(seed, k)))
        return state, step

    @contextlib.contextmanager
    def planted(self, fault, state):
        """The step broken underneath while the block runs (faults the
        check must catch)."""
        loop, mesh_lib = self.loop, self.mesh_lib
        whole, reduce = loop.loss_from_batch, mesh_lib.all_reduce_sum
        if fault == "state_unchanged":
            state.optimizer.step = lambda *a, **k: None
        elif fault == "half_batch":
            def half(model, batch, cfg):
                return whole(model, tuple(t[:t.shape[0] // 2]
                                          for t in batch), cfg)
            loop.loss_from_batch = half
        elif fault == "no_exchange":
            mesh_lib.all_reduce_sum = lambda mesh, t: t.clone()
        elif fault is not None:
            raise ValueError(f"unknown fault {fault!r}")
        try:
            yield
        finally:
            loop.loss_from_batch, mesh_lib.all_reduce_sum = whole, reduce

    def first_steps(self, state, step, seed: int) -> dict:
        """The program's readings of its first steps."""
        named = dict(state.model.named_parameters())
        p0 = {n: p.detach().clone() for n, p in named.items()}
        beta1 = state.optimizer.param_groups[0]["betas"][0]
        losses, grad = [], {}
        for k in range(CHECKED_STEPS):
            losses.append(step(seed, k)["total"].detach())
            if k == 0:
                opt = state.optimizer.state
                grad = {n: float(opt[p]["exp_avg"].norm()) / (1.0 - beta1)
                        if p in opt else 0.0 for n, p in named.items()}
        change = {n: float((p.detach() - p0[n]).norm())
                  for n, p in named.items()}
        return {"losses": [float(v) for v in losses], "grad": grad,
                "change": change}

    def free(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def run_rank(ctx: harness.Ctx) -> harness.Run:
    import torch.distributed as dist
    tr = Trainer(ctx)
    spec, dev, traffic = ctx.spec, ctx.device, ctx.spec.traffic
    t = time.monotonic()
    state, step = tr.fresh()
    with tr.planted(ctx.fault, state):
        prog = tr.first_steps(state, step, ctx.seed)
        k = CHECKED_STEPS
        for _ in range(WARMUP_STEPS):
            step(ctx.seed, k)
            k += 1
        harness.sync(dev)
        t1 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            step(ctx.seed, k)
            k += 1
        harness.sync(dev)
        per_step = (time.perf_counter() - t1) / TIMED_STEPS
        n_steps = torch.tensor([max(1, round(ctx.seconds / per_step))],
                               device=dev)
        if ctx.world > 1:
            dist.all_reduce(n_steps, op=dist.ReduceOp.MAX)
            dist.barrier()
        n_steps = int(n_steps)
        harness.sync(dev)
        ctx.part("warmup", time.monotonic() - t)

        traces: list = []
        setup_s = time.monotonic() - ctx.t_start
        with (tracing.capture(dev, traces) if ctx.trace
              else contextlib.nullcontext()):
            t0 = time.perf_counter()
            for _ in range(n_steps):
                aux = step(ctx.seed, k)
                k += 1
            harness.sync(dev)
            window_s = time.perf_counter() - t0
    last = float(aux["total"])
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del state, step, aux
    tr.free()
    checks = compare(prog, reference_readings(spec, dev, ctx.seed))
    return harness.Run(
        spec=spec, rank=ctx.rank, world=ctx.world, setup_s=setup_s,
        window_s=window_s,
        work={"steps": n_steps, "samples": n_steps * traffic["batch_size"],
              "batch": traffic["batch_size"],
              "rank_batch": traffic["batch_size"] // ctx.world},
        stamps={}, stages={}, checks=checks, attempted=n_steps,
        failed=0 if abs(last) < float("inf") else n_steps,
        memory_peak_bytes=int(peak), trace=traces[0] if traces else None)


def sweep(ctx: harness.Ctx, seeds) -> list:
    """Per seed, the numbers compared for the program, for the control
    (the reference with TF32 on, in the program's place) and for each
    fault planted in the program; no window."""
    tr = Trainer(ctx)
    faults = ["half_batch"] + (["no_exchange"] if ctx.world > 1 else [])
    out = []
    for seed in seeds:
        ref = reference_readings(ctx.spec, ctx.device, seed)
        rec = {"seed": seed}
        for fault in [None] + faults:
            state, step = tr.fresh()
            with tr.planted(fault, state):
                prog = tr.first_steps(state, step, seed)
            del state, step
            tr.free()
            rec[fault or "program"] = compare(prog, ref)
        rec["control"] = compare(reference_readings(
            ctx.spec, ctx.device, seed, tf32=True), ref)
        out.append(rec)
    return out
