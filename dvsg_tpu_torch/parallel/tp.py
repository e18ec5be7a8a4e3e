"""Tensor parallelism: the motion CNN with its convolutions' output channels
split over the mesh's ``model`` axis.

The JAX package shards the conv kernels (``tp_param_sharding``) and lets
GSPMD emit the collectives. Here that forward is written out, for
inference:

* each rank of a ``model`` axis of m ranks holds, of every conv that
  ``tp_param_sharding`` shards, the output channels [r·cout/m, (r+1)·cout/m)
  of its kernel and bias, and computes that share of the conv;
* a ResBlock's GroupNorm of ``GN_GROUPS`` groups normalizes its shard
  locally: with m dividing the group count a shard holds whole groups (the
  channels of a group are contiguous), so its statistics are its own;
* the shards are all-gathered on channels right after the conv (and its
  norm), before anything that needs every channel: the next conv, the
  correlation, the residual add;
* a conv the spec replicates (the head's 2-channel output unless m divides
  2) runs whole on every rank.

``tp_model`` returns a ``MotionEstimator`` of that forward, which every
chunk step takes as it is: each rank of a model group runs the same chunk,
its share of each conv, and the offsets kernel over the whole chunk.
``TPStabilizer`` is the ``Stabilizer`` on it, which shards a clip batch
over the ``data`` axis.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
import torch.nn as nn

from dvsg_tpu_torch.config import StabilizeConfig
from dvsg_tpu_torch.models.motion_cnn import (GN_GROUPS, MotionEstimator,
                                              ResBlock, SameConv2d, conv_norm,
                                              gelu)
from dvsg_tpu_torch.parallel import mesh as mesh_lib
from dvsg_tpu_torch.pipeline.stabilize import ChunkStep, Stabilizer


def gather_channels(axis: mesh_lib.Mesh, y: torch.Tensor) -> torch.Tensor:
    """Every rank's NCHW channel shard ``y``, concatenated on channels in
    rank order, on every rank of the 1-D mesh ``axis``."""
    return mesh_lib.all_gather(axis, y.movedim(1, 0)).movedim(0, 1
                                                              ).contiguous()


def _shard_conv(conv: SameConv2d, r: int, m: int) -> SameConv2d:
    k = conv.out_channels // m
    out = SameConv2d(conv.in_channels, k, conv.kernel_size[0],
                     conv.stride[0]).to(conv.weight.device)
    with torch.no_grad():
        out.weight.copy_(conv.weight[r * k:(r + 1) * k])
        out.bias.copy_(conv.bias[r * k:(r + 1) * k])
    return out.eval()


def _shard_norm(norm: nn.GroupNorm, r: int, m: int) -> nn.GroupNorm:
    k = norm.num_channels // m
    out = nn.GroupNorm(norm.num_groups // m, k, eps=norm.eps
                       ).to(norm.weight.device)
    with torch.no_grad():
        out.weight.copy_(norm.weight[r * k:(r + 1) * k])
        out.bias.copy_(norm.bias[r * k:(r + 1) * k])
    return out.eval()


class _GatheredConv(nn.Module):
    """A conv's output-channel shard on this rank, gathered: the whole
    conv's output on every rank of the axis."""

    def __init__(self, conv: SameConv2d, axis: mesh_lib.Mesh):
        super().__init__()
        self.axis = axis
        self.conv = _shard_conv(conv, axis.rank, axis.size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gather_channels(self.axis, self.conv(x))


class _TPResBlock(nn.Module):
    """``ResBlock`` with both convs and their GroupNorms sharded: each rank
    convolves and normalizes its whole groups, then the channels are
    gathered."""

    def __init__(self, block: ResBlock, axis: mesh_lib.Mesh):
        super().__init__()
        self.axis = axis
        r, m = axis.rank, axis.size
        self.conv1, self.conv2 = (_shard_conv(block.conv1, r, m),
                                  _shard_conv(block.conv2, r, m))
        self.gn1, self.gn2 = (_shard_norm(block.gn1, r, m),
                              _shard_norm(block.gn2, r, m))

    def forward(self, x: torch.Tensor, f32_out: bool = False
                ) -> torch.Tensor:
        h = gelu(gather_channels(self.axis,
                                 conv_norm(self.conv1, self.gn1, x)))
        h = gather_channels(self.axis, conv_norm(self.conv2, self.gn2, h))
        return gelu(x + h, f32_out)


def tp_model(model: MotionEstimator, mesh: mesh_lib.Mesh
             ) -> MotionEstimator:
    """A copy of ``model`` whose convs are sharded over ``mesh``'s
    ``model`` axis as ``tp_param_sharding`` says, on this rank. Every rank
    of the axis must call it, and run the copy on the same inputs. Raises
    ``ValueError`` on a mesh without a ``model`` axis, or when a sharded
    ResBlock's GroupNorm groups do not divide over the axis, and on the
    pwc arch, whose convs no spec shards."""
    if model.cfg.arch == "pwc":
        raise ValueError("tensor parallelism shards the corr and stacked "
                         "archs' convs; arch 'pwc' is not supported")
    spec = mesh_lib.tp_param_sharding(mesh, model.state_dict())
    axis = mesh.along(mesh_lib.MODEL_AXIS)
    tp = copy.deepcopy(model)
    if axis.size == 1:
        return tp
    for name, mod in model.named_modules():
        parent, _, leaf = name.rpartition(".")
        if isinstance(model.get_submodule(parent), ResBlock):
            continue                    # sharded with its block
        if isinstance(mod, ResBlock) and spec[f"{name}.conv1.weight"]:
            if GN_GROUPS % axis.size:
                raise ValueError(f"a model axis of {axis.size} ranks does "
                                 f"not divide the GroupNorm's {GN_GROUPS} "
                                 "groups")
            setattr(tp.get_submodule(parent), leaf, _TPResBlock(mod, axis))
        elif isinstance(mod, SameConv2d) and spec[f"{name}.weight"]:
            setattr(tp.get_submodule(parent), leaf, _GatheredConv(mod, axis))
    return tp


class TPStabilizer(Stabilizer):
    """A ``Stabilizer`` whose motion CNN is split over the mesh's ``model``
    axis (``tp_model``), on this rank's device; every rank of a model group
    returns the same frames. ``stabilize_clips`` shards a batch of clips
    over the ``data`` axis, when the mesh has one, and gathers them."""

    def __init__(self, cfg: StabilizeConfig, params: dict,
                 mesh: mesh_lib.Mesh):
        super().__init__(cfg, params, device=mesh.device)
        self.mesh = mesh
        self.model = tp_model(self.model, mesh)
        self.step = ChunkStep(cfg, self.model, device=self.device)

    def stabilize_clips(self, clips_u8: np.ndarray) -> np.ndarray:
        """(B, T, H, W, C) uint8 → stabilized, B/d clips on each of the d
        ranks of the ``data`` axis; every rank gets the whole batch."""
        if mesh_lib.DATA_AXIS not in self.mesh.axis_names:
            return np.stack([self.stabilize_clip(c) for c in clips_u8])
        data = self.mesh.along(mesh_lib.DATA_AXIS)
        mine = clips_u8[data.shard(len(clips_u8), "clip batch")]
        out = np.stack([self.stabilize_clip(c) for c in mine])
        return mesh_lib.all_gather_rows(data, out)
