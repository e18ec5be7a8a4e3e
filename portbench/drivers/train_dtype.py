"""``train.py``'s training steps, ``correct`` and faults, for a
configuration that computes in another dtype than its checkpoint's
record: the committed float32 weights fine-tuned in bfloat16, as
``python -m dvsg_tpu_torch train --dtype bfloat16`` does.

The configuration's ``dtype`` is folded onto the checkpoint's record by
the rule of ``cli.py::_apply_dtype``; any other difference between the
two is refused. ``correct`` compares with the float32 reference as
``train.py`` does. The control of ``sweep`` is that reference with its
trunk rounded below bf16's precision (``reference/lowp.py``), in the
program's place, in place of ``train.py``'s TF32 control, which is not
below bf16.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from portbench import harness
from portbench.reference import lowp

# This driver's own instance of train.py, whose Trainer is replaced below
# (the harness loads train.py afresh for the cells that run it).
_train = harness.load_module("drivers", "train")


def checkpoint_record(path: str) -> dict:
    """The model config record (``__config__``) of a checkpoint file."""
    with np.load(path) as z:
        return json.loads(bytes(z["__config__"].tobytes()).decode())


def fold(record: dict, model: dict):
    """The ModelConfig of checkpoint ``record`` with the configuration's
    ``dtype``; ValueError if ``model`` differs from the record otherwise."""
    from dvsg_tpu_torch.config import model_config_from_dict
    want = model_config_from_dict(model)
    folded = dataclasses.replace(model_config_from_dict(record),
                                 dtype=want.dtype)
    if folded != want:
        raise ValueError(f"the checkpoint holds {record}, which differs from "
                         f"the configuration's {model} in more than dtype")
    return folded


class Trainer(_train.Trainer):
    """``train.Trainer`` on the checkpoint's weights, its steps in the
    configuration's dtype."""

    def __init__(self, ctx: harness.Ctx):
        config = ctx.spec.config
        record = checkpoint_record(os.path.join(harness.ROOT,
                                                config["checkpoint"]))
        mcfg = fold(record, config["model"])
        as_saved = dataclasses.replace(
            ctx.spec, config=dict(config, model=record))
        super().__init__(dataclasses.replace(ctx, spec=as_saved))
        self.ctx = ctx
        self.tcfg = dataclasses.replace(self.tcfg, model=mcfg)


_train.Trainer = Trainer
run_rank = _train.run_rank


def control_readings(spec, device, seed: int) -> dict:
    """The reference's readings of the first steps with its trunk rounded
    to ``lowp.MANTISSA_BITS`` mantissa bits."""
    with lowp.rounded_trunk():
        return _train.reference_readings(spec, device, seed)


def sweep(ctx: harness.Ctx, seeds) -> list:
    """Per seed, the numbers compared for the program, for the control
    (``control_readings``) and for the half-batch fault; no window."""
    tr = Trainer(ctx)
    out = []
    for seed in seeds:
        ref = _train.reference_readings(ctx.spec, ctx.device, seed)
        rec = {"seed": seed}
        for fault in (None, "half_batch"):
            state, step = tr.fresh()
            with tr.planted(fault, state):
                prog = tr.first_steps(state, step, seed)
            del state, step
            tr.free()
            rec[fault or "program"] = _train.compare(prog, ref)
        rec["control"] = _train.compare(
            control_readings(ctx.spec, ctx.device, seed), ref)
        out.append(rec)
    return out
