"""Motion-estimation CNN: sliding frame window → coarse offsets.

Three architectures (``cfg.arch``); the first two as in the reference:

* ``corr``: a siamese per-frame encoder (stem conv + stride-2 ResBlock
  pyramid down to the coarse grid), PWC-style local correlation volumes of
  every window frame against the last one, and a small float32 regression
  head;
* ``stacked``: the same trunk over the channel-stacked window
  (``window * channels`` channels), then a float32 ``head_conv`` → GELU →
  ``head_out``;
* ``pwc``: PWC-Net (Sun et al., CVPR 2018, arXiv:1709.02371; NVlabs'
  ``PWCDCNet``) as the motion estimator, float32 only: a six-level
  feature pyramid per frame, then per pair of the window's last frame
  (the reference, a) and another window frame (b) a coarse-to-fine
  decoder (cost volume of radius ``corr_radius`` = 4 on levels 6 to 2,
  b warped by the upsampled flow below level 6, dense conv estimators,
  the dilated context network at level 2) giving the flow a → b at level
  2; see ``PwcEncoder`` and ``MotionEstimator.pwc_flow``. Its head is not
  PWC-Net's: each pair's flow is average-pooled 4 x 4 onto the grid,
  concatenated with a's level-4 features and fed to the corr arch's
  three-conv head.

Parameter names follow the reference checkpoints' paths
(``encoder.stem``, ``encoder.down{l}``, ``encoder.res{l}_{b}.conv1``,
``head_conv1``, ...; the stacked arch's trunk sits at the top: ``stem``,
``down{l}``, ``res{l}_{b}``, ``head_conv``, ``head_out``; see
utils/checkpoint.py). Three details of the reference that differ from
PyTorch defaults:

* ``SAME`` padding pads a stride-2 3×3 conv on an even input by (0, 1),
  not (1, 1): ``SameConv2d`` pads as the reference does;
* its GELU is the tanh approximation;
* its GroupNorm has epsilon 1e-6 (8 groups here).

With ``cfg.dtype == "bfloat16"`` the trunk computes in bf16 while the
parameters stay float32, and rounds where the reference (flax on XLA)
rounds, which is not where PyTorch's fused bf16 ops round:

* a conv rounds its result to bf16, then adds the bias in bf16;
* GELU is the tanh formula op by op, each op rounded, its constants
  rounded to bf16 first (a weakly typed constant takes the array's type;
  ops/bf16_round.py: on the card one kernel does the whole chain);
* GroupNorm takes its statistics and normalizes in f32, rounding once;
  it normalizes the conv's f32 sum with its bias, as XLA's fusion does
  (ops/bf16_round.py: on the card one kernel does the bias add and the
  whole GroupNorm, one more its gradient);
* a correlation's products and sum are f32, rounded once, then scaled;
* the heads are f32; the stacked head reads the trunk's last GELU
  unrounded (XLA drops the rounding before the reference's cast to f32).

Under autograd the backward rounds where JAX's gradient, compiled by XLA,
does: GELU's gradient is its JVP transposed op by op; a conv's kernel
gradient stays f32 and its bias gradient is a sequential bf16 sum; each
cast of a bf16 value to f32 rounds its own share of the gradient; the
correlation's gradient sums its shifts one by one in bf16 (autograd
functions whose forward is the plain computation).

Under a profiler the bf16 rounding passes (GELU, the bias adds and the
GroupNorm, forward and backward) run inside the span ``bf16_round`` and
the correlation's gradient inside ``corr_bwd`` (``utils/metrics.py::span``);
the pwc arch's cost volumes inside ``pwc_corr`` and its feature warps
inside ``pwc_warp`` (forward only: their backward is autograd's, of
plain ops). ``PWC_FRAMES`` and ``PWC_PAIRS`` count the pyramids and the
decoder passes the pwc arch computes.

The pwc arch departs from ``PWCDCNet`` in three ways, besides its head:
its input is the port's normalized frame (``resize.downscale_norm``,
centered at 0) at the model size, not a 0-255 image at PWC-Net's crop;
its cost volume is the port's ``correlation_volume`` (zero padding, the
channel mean) in place of the CUDA correlation package; and each pair's
flow is read at level 2 only, without PWC-Net's multi-scale training
loss (the port's self-supervised loss trains it through the head).

Public functions keep the reference's NHWC layouts.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from dvsg_tpu_torch.config import ModelConfig
from dvsg_tpu_torch.ops import bf16_round
from dvsg_tpu_torch.ops import grid as grid_ops
from dvsg_tpu_torch.ops.grouped import each
from dvsg_tpu_torch.utils.metrics import span

GN_GROUPS = 8
GN_EPS = 1e-6
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_ARCHS = ("corr", "stacked", "pwc")

# PWC-Net (PWCDCNet): pyramid widths of levels 1-6, the dense estimator's
# conv widths, the context network's (width, dilation) convs, the flow
# scale (flow is regressed in units of 1/20 of a level-0 pixel), and the
# level whose features the head reads.
PWC_WIDTHS = (16, 32, 64, 96, 128, 196)
PWC_DENSE = (128, 128, 96, 64, 32)
PWC_CONTEXT = ((128, 1), (128, 2), (128, 4), (96, 8), (64, 16), (32, 1))
PWC_FLOW_SCALE = 20.0
PWC_HEAD_LEVEL = 4
# Pyramids encoded and decoder passes run by the pwc arch (padding rows of
# a fixed-size call included), in the process.
PWC_FRAMES = 0
PWC_PAIRS = 0


class _GeluBf16(torch.autograd.Function):
    """jax.nn.gelu on bf16 ``x`` and the gradient JAX derives for it, as
    the registered ops of ``ops/bf16_round.py``: one kernel each on the
    card, the plain op chain on the CPU."""

    @staticmethod
    def forward(ctx, x, f32_out):
        ctx.save_for_backward(x)
        with span("bf16_round"):
            return bf16_round.gelu_bf16(x, f32_out)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        with span("bf16_round"):
            return bf16_round.gelu_bf16_bwd(x, g), None


def gelu(x: torch.Tensor, f32_out: bool = False) -> torch.Tensor:
    """The reference's GELU (tanh form). On bf16 ``x`` it rounds where
    XLA does; ``f32_out`` returns the last product unrounded, in f32."""
    if x.dtype != torch.bfloat16:
        return F.gelu(x, approximate="tanh")
    return _GeluBf16.apply(x, f32_out)


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """(low, high) padding of XLA's ``SAME`` along one axis: output
    ceil(n / s), the odd pixel of padding goes at the high end."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _bf16_valued(w: torch.Tensor) -> torch.Tensor:
    """``w`` rounded to bf16 but kept f32, its gradient passed through in
    f32: XLA computes a bf16 conv's kernel gradient in f32 and drops the
    round trip through bf16 that the kernel's cast would add."""
    return w + (w.to(torch.bfloat16).float() - w).detach()


class _GroupNormBf16(torch.autograd.Function):
    """A bf16 conv's bias add and the GroupNorm after it, as the reference
    rounds them, and their gradient: the registered ops of
    ``ops/bf16_round.py``, one kernel forward and one backward on the
    card, the plain op chain and the gradient autograd takes through it on
    the CPU."""

    @staticmethod
    def forward(ctx, x, bias, weight, beta, groups, eps):
        with span("bf16_round"):
            y, stats = bf16_round.group_norm_bf16(x, bias, weight, beta,
                                                  groups, eps)
        ctx.save_for_backward(x, stats, bias, weight)
        ctx.groups, ctx.eps = groups, eps
        return y

    @staticmethod
    def backward(ctx, g):
        x, stats, bias, weight = ctx.saved_tensors
        with span("bf16_round"):
            grads = bf16_round.group_norm_bf16_bwd(
                g, x, stats, bias, weight, ctx.groups, ctx.eps)
        return *grads, None, None


class SameConv2d(nn.Conv2d):
    """Conv2d (NCHW) with the reference's ``padding="SAME"``; on bf16
    input the bf16 kernel's conv is rounded, then the bias is added in
    bf16."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__(cin, cout, k, stride=stride, padding=0)

    def _pads(self, x: torch.Tensor) -> tuple:
        k, s = self.kernel_size[0], self.stride[0]
        return same_pads(x.shape[-2], k, s), same_pads(x.shape[-1], k, s)

    def unbiased_bf16(self, x: torch.Tensor) -> torch.Tensor:
        """The bf16 conv without its bias: f32 products and sums of the
        bf16 input and kernel, rounded once to bf16. On the CPU it runs as
        an f32 conv, so that the kernel's gradient stays f32 as XLA's does
        (a bf16 ``F.conv2d`` rounds it to bf16)."""
        ph, pw = self._pads(x)
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        if x.is_cuda:           # cuDNN: f32 accumulation, one rounding
            return F.conv2d(x, self.weight.to(x.dtype), None, self.stride[0])
        return F.conv2d(x.float(), _bf16_valued(self.weight), None,
                        self.stride[0]).to(x.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.bfloat16:
            return bf16_round.BiasAddBf16.apply(self.unbiased_bf16(x),
                                                self.bias)
        ph, pw = self._pads(x)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            return F.conv2d(x, self.weight, self.bias, self.stride[0],
                            (ph[0], pw[0]))
        return super().forward(F.pad(x, (pw[0], pw[1], ph[0], ph[1])))


def _group_norm(c: int) -> nn.GroupNorm:
    return nn.GroupNorm(GN_GROUPS, c, eps=GN_EPS)


def conv_norm(conv: SameConv2d, norm: nn.GroupNorm, x: torch.Tensor
              ) -> torch.Tensor:
    """``norm(conv(x))``; on bf16 ``x`` as the reference computes it:
    flax's f32 statistics (mean and E[x²] − mean², clamped at 0) of the
    bf16 conv output, then f32 normalize, scale and shift, one rounding to
    bf16. XLA fuses the conv's bias add into the normalize and keeps that
    sum in f32 there (the statistics read it rounded), so this does too.
    The statistics and the normalize each cast the input to f32, so each
    path's share of its gradient is rounded to bf16 before they add
    (``ops/bf16_round.py``: one kernel each way on the card, which takes
    the statistics and sums in its own order; the op chain on the CPU)."""
    if x.dtype != torch.bfloat16:
        return norm(conv(x))
    return _GroupNormBf16.apply(conv.unbiased_bf16(x), conv.bias,
                                norm.weight, norm.bias, norm.num_groups,
                                norm.eps)


class ResBlock(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = SameConv2d(features, features, 3)
        self.gn1 = _group_norm(features)
        self.conv2 = SameConv2d(features, features, 3)
        self.gn2 = _group_norm(features)

    def forward(self, x: torch.Tensor, f32_out: bool = False
                ) -> torch.Tensor:
        h = gelu(conv_norm(self.conv1, self.gn1, x))
        h = conv_norm(self.conv2, self.gn2, h)
        return gelu(x + h, f32_out)


def pyramid_levels(cfg: ModelConfig) -> int:
    """Stride-2 stages from model_size down to grid_size (the reference's
    ``_stem_pyramid`` loop)."""
    mh, mw = cfg.model_size
    down, level = 1, 0
    while (mh // down, mw // down) != tuple(cfg.grid_size) \
            and level < cfg.levels * 2:
        down *= 2
        level += 1
    if (mh // down, mw // down) != tuple(cfg.grid_size):
        raise ValueError(
            f"cannot reach grid_size {cfg.grid_size} from "
            f"model_size {cfg.model_size} by stride-2 stages")
    return level


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got "
                         f"{cfg.dtype!r}")
    return _DTYPES[cfg.dtype]


def _add_trunk(mod: nn.Module, cfg: ModelConfig, cin: int) -> int:
    """Register the reference's ``_stem_pyramid`` (``stem``, ``down{l}``,
    ``res{l}_{b}``) on ``mod``; returns its output width."""
    feats = cfg.base_features
    mod.stem = SameConv2d(cin, feats, 7)
    for level in range(pyramid_levels(cfg)):
        nxt = min(feats * 2, 256)
        mod.add_module(f"down{level}", SameConv2d(feats, nxt, 3, 2))
        for b in range(cfg.blocks_per_level):
            mod.add_module(f"res{level}_{b}", ResBlock(nxt))
        feats = nxt
    return feats


def _trunk(mod: nn.Module, cfg: ModelConfig, x: torch.Tensor,
           f32_out: bool = False) -> torch.Tensor:
    """The trunk registered by ``_add_trunk``, in the compute dtype. With
    ``f32_out`` its last GELU's product comes back unrounded in f32: the
    stacked head casts the trunk to f32, and XLA drops that rounding."""
    levels, blocks = pyramid_levels(cfg), cfg.blocks_per_level
    x = gelu(mod.stem(x.to(compute_dtype(cfg))), f32_out and levels == 0)
    for level in range(levels):
        last = f32_out and level == levels - 1
        x = gelu(getattr(mod, f"down{level}")(x), last and blocks == 0)
        for b in range(blocks):
            x = getattr(mod, f"res{level}_{b}")(x, last and b == blocks - 1)
    return x


class FrameEncoder(nn.Module):
    """Per-frame encoder: NCHW (B, C, Hm, Wm) → (B, F, gh, gw), in the
    compute dtype."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.out_features = _add_trunk(self, cfg, cfg.channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _trunk(self, self.cfg, x)


def correlation_volume(ref: torch.Tensor, other: torch.Tensor,
                       radius: int, scale: Optional[float] = None
                       ) -> torch.Tensor:
    """Local cost volumes, NCHW: ref (B, F, gh, gw) against each of
    other (B, K, F, gh, gw) → (B, K, (2r+1)^2, gh, gw). Channel
    dy * (2r+1) + dx holds sum_f ref * other[shifted by (dy - r, dx - r)]
    * scale, with ``other`` zero-padded by ``radius``; ``scale`` defaults
    to the corr arch's F^-0.5 (the pwc arch passes 1 / F). On bf16
    features the products and sum are f32, rounded once, then scaled in
    bf16."""
    f, gh, gw = ref.shape[-3:]
    k = 2 * radius + 1
    if scale is None:
        scale = float(f) ** -0.5
    low = ref.dtype == torch.bfloat16
    pad = F.pad(other, (radius, radius, radius, radius))
    ref = ref[:, None]
    if low:
        ref, pad = ref.float(), pad.float()
    vols = [(ref * pad[..., dy:dy + gh, dx:dx + gw]).sum(dim=2)
            for dy in range(k) for dx in range(k)]
    if low:
        return (torch.stack(vols, dim=2).to(torch.bfloat16)
                * bf16_round.bf16(scale))
    return torch.stack(vols, dim=2) * scale


class _CorrInputBf16(torch.autograd.Function):
    """The corr head's bf16 input: ``correlation_volume`` of ``ref``
    (B, F, gh, gw) against each of ``others`` (B, K, F, gh, gw), then
    ``ref``, on channels. Its gradient is the one JAX derives, each op
    rounded to bf16 and summed in the order of XLA's fusion: each frame's
    shifts last to first, and the ref's share from its concat share on,
    frames last to first."""

    @staticmethod
    def forward(ctx, ref, others, radius):
        ctx.save_for_backward(ref, others)
        ctx.radius = radius
        vols = correlation_volume(ref, others, radius)
        return torch.cat([vols.flatten(1, 2), ref], dim=1)

    @staticmethod
    def backward(ctx, g):
        ref, others = ctx.saved_tensors
        r = ctx.radius
        b, k, f, gh, gw = others.shape
        n = (2 * r + 1) ** 2
        with span("corr_bwd"):
            g = g.to(ref.dtype)
            gv = g[:, :k * n].reshape(b, k, n, gh, gw) * bf16_round.bf16(
                float(f) ** -0.5)
            pad = F.pad(others, (r, r, r, r))
            d_ref = g[:, k * n:].clone()
            d_pad = torch.zeros_like(pad)
            for kk in reversed(range(k)):
                for sh in reversed(range(n)):
                    dy, dx = divmod(sh, 2 * r + 1)
                    c = gv[:, kk, sh, None]
                    d_ref = d_ref + c * pad[:, kk, :, dy:dy + gh, dx:dx + gw]
                    d_pad[:, kk, :, dy:dy + gh, dx:dx + gw] += c * ref
            return d_ref, d_pad[..., r:r + gh, r:r + gw], None


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


def _conv3(cin: int, cout: int, stride: int = 1, dilation: int = 1
           ) -> nn.Conv2d:
    """PWC-Net's 3 x 3 conv: PyTorch's symmetric padding by the dilation
    (a stride-2 conv pads (1, 1), where ``SameConv2d`` pads (0, 1))."""
    return nn.Conv2d(cin, cout, 3, stride, padding=dilation,
                     dilation=dilation)


def _deconv(cin: int) -> nn.ConvTranspose2d:
    """PWC-Net's 4 x 4 stride-2 transposed conv to 2 channels."""
    return nn.ConvTranspose2d(cin, 2, 4, 2, 1)


class PwcEncoder(nn.Module):
    """PWC-Net's feature pyramid: per level l = 1..6 a stride-2 conv and
    two convs, each followed by LeakyReLU(0.1). NVlabs' names: level l's
    convs are ``conv{l}a``, ``conv{l}aa``, ``conv{l}b``, level 6's
    ``conv6aa`` (the stride-2 one), ``conv6a``, ``conv6b``."""

    def __init__(self, cin: int):
        super().__init__()
        for level, width in enumerate(PWC_WIDTHS, 1):
            for i, name in enumerate(self.names(level)):
                self.add_module(name, _conv3(cin, width, 2 if i == 0 else 1))
                cin = width

    @staticmethod
    def names(level: int) -> tuple:
        if level == 6:
            return ("conv6aa", "conv6a", "conv6b")
        return (f"conv{level}a", f"conv{level}aa", f"conv{level}b")

    def forward(self, x: torch.Tensor) -> tuple:
        """NCHW frames → levels 2..6 (level 1 feeds only level 2)."""
        out = []
        for level in range(1, 7):
            for name in self.names(level):
                x = _leaky(getattr(self, name)(x))
            if level >= 2:
                out.append(x)
        return tuple(out)


def feature_warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """PWC-Net's warp (NVlabs' ``warp``): x (B, C, H, W) sampled
    bilinearly at p + flow(p) (flow (B, 2, H, W), (u, v) in pixels),
    align-corners coordinates, zero outside the map, times the mask of
    samples whose four taps lie inside (a warped map of ones >= 0.9999).
    Differentiable in x and in flow; the mask carries no gradient."""
    b, _, h, w = x.shape
    xs = torch.arange(w, dtype=flow.dtype, device=flow.device)
    ys = torch.arange(h, dtype=flow.dtype, device=flow.device)
    gx = 2.0 * (xs + flow[:, 0]) / max(w - 1, 1) - 1.0
    gy = 2.0 * (ys[:, None] + flow[:, 1]) / max(h - 1, 1) - 1.0
    grid = torch.stack([gx, gy], dim=-1)
    out = F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                        align_corners=True)
    with torch.no_grad():
        ones = torch.ones((b, 1, h, w), dtype=x.dtype, device=x.device)
        mask = F.grid_sample(ones, grid, mode="bilinear",
                             padding_mode="zeros", align_corners=True)
    return out * (mask >= 0.9999).to(x.dtype)


class MotionEstimator(nn.Module):
    """The motion CNN of ``cfg.arch``; the parameter tree of one
    checkpoint."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.arch not in _ARCHS:
            raise ValueError(f"arch must be one of {_ARCHS}, got "
                             f"{cfg.arch!r}")
        compute_dtype(cfg)
        self.cfg = cfg
        if cfg.arch == "stacked":
            feats = _add_trunk(self, cfg, cfg.window * cfg.channels)
            self.head_conv = SameConv2d(feats, feats, 3)
            self.head_out = SameConv2d(feats, 2, 3)
            return
        if cfg.arch == "pwc":
            self.encoder = PwcEncoder(cfg.channels)
            self._add_pwc_decoder()
            head_in = 2 * (cfg.window - 1) + PWC_WIDTHS[PWC_HEAD_LEVEL - 1]
        else:
            self.encoder = FrameEncoder(cfg)
            n_corr = (cfg.window - 1) * (2 * cfg.corr_radius + 1) ** 2
            head_in = n_corr + self.encoder.out_features
        self.head_conv1 = SameConv2d(head_in, 128, 3)
        self.head_conv2 = SameConv2d(128, 128, 3)
        self.head_out = SameConv2d(128, 2, 3)

    def _add_pwc_decoder(self) -> None:
        """PWCDCNet's estimators, NVlabs' names: per level l = 6..2 the
        dense convs ``conv{l}_0..4``, ``predict_flow{l}`` and, above level
        2, ``deconv{l}`` (the flow's) and ``upfeat{l}`` (the features');
        the context network ``dc_conv1..7``."""
        n_corr = (2 * self.cfg.corr_radius + 1) ** 2
        for level in range(6, 1, -1):
            cin = n_corr if level == 6 else (
                n_corr + PWC_WIDTHS[level - 1] + 4)
            for i, width in enumerate(PWC_DENSE):
                self.add_module(f"conv{level}_{i}", _conv3(cin, width))
                cin += width
            self.add_module(f"predict_flow{level}", _conv3(cin, 2))
            if level > 2:
                self.add_module(f"deconv{level}", _deconv(2))
                self.add_module(f"upfeat{level}", _deconv(cin))
        for i, (width, dilation) in enumerate(PWC_CONTEXT, 1):
            self.add_module(f"dc_conv{i}", _conv3(cin, width, 1, dilation))
            cin = width
        self.add_module("dc_conv7", _conv3(cin, 2))

    def pwc_flow(self, a: tuple, b: tuple) -> torch.Tensor:
        """PWC-Net's flow a → b at level 2, NCHW: a, b the pyramids
        (levels 2..6, each (P, C_l, H_l, W_l)) of P pairs → (P, 2, H_2,
        W_2), in units of 1/20 of a level-0 pixel (PWC-Net's)."""
        global PWC_PAIRS
        PWC_PAIRS += a[0].shape[0]
        up_flow = up_feat = None
        for level in range(6, 1, -1):
            al, bl = a[level - 2], b[level - 2]
            if up_flow is not None:
                with span("pwc_warp"):
                    bl = feature_warp(
                        bl, up_flow * (PWC_FLOW_SCALE / 2 ** level))
            with span("pwc_corr"):
                vol = correlation_volume(al, bl[:, None],
                                         self.cfg.corr_radius,
                                         1.0 / al.shape[1])[:, 0]
            x = _leaky(vol)
            if up_flow is not None:
                x = torch.cat([x, al, up_flow, up_feat], dim=1)
            for i in range(len(PWC_DENSE)):
                x = torch.cat([_leaky(getattr(self, f"conv{level}_{i}")(x)),
                               x], dim=1)
            flow = getattr(self, f"predict_flow{level}")(x)
            if level > 2:
                up_flow = getattr(self, f"deconv{level}")(flow)
                up_feat = getattr(self, f"upfeat{level}")(x)
        for i in range(1, len(PWC_CONTEXT) + 1):
            x = _leaky(getattr(self, f"dc_conv{i}")(x))
        return flow + self.dc_conv7(x)

    def pwc_offsets(self, pyramids: tuple) -> torch.Tensor:
        """The pwc arch's offsets, NCHW: pyramids (levels 2..6, each
        (B, N, C_l, H_l, W_l)) of B windows → (B, 2, gh, gw). Each of the
        N - 1 earlier frames is paired with the last, in window order."""
        b, n = pyramids[0].shape[:2]
        ref = pyramids[PWC_HEAD_LEVEL - 2][:, -1]
        if n > 1:
            a = tuple(p[:, -1:].expand(-1, n - 1, *p.shape[2:]).flatten(0, 1)
                      for p in pyramids)
            others = tuple(p[:, :-1].flatten(0, 1) for p in pyramids)
            flow = F.avg_pool2d(self.pwc_flow(a, others), 4)
            ref = torch.cat([flow.reshape(b, -1, *flow.shape[2:]), ref],
                            dim=1)
        x = gelu(self.head_conv1(ref))
        x = gelu(self.head_conv2(x))
        return torch.tanh(self.head_out(x)) * self.cfg.max_offset

    def head(self, feats: torch.Tensor) -> torch.Tensor:
        """Correlation volumes + regression head, NCHW: feats
        (B, N, F, gh, gw) → offsets (B, 2, gh, gw)."""
        cfg = self.cfg
        n = cfg.window
        b, _, _, gh, gw = feats.shape
        ref = feats[:, -1]                  # the frame being stabilized
        if n > 1 and feats.dtype == torch.bfloat16:
            x = _CorrInputBf16.apply(ref, feats[:, :-1], cfg.corr_radius)
        elif n > 1:
            vols = correlation_volume(ref, feats[:, :-1], cfg.corr_radius)
            # window frame k's (2r+1)^2 channels, in order, then ref
            x = torch.cat([vols.reshape(b, -1, gh, gw), ref], dim=1)
        else:
            x = ref
        x = gelu(self.head_conv1(x.to(torch.float32)))
        x = gelu(self.head_conv2(x))
        return torch.tanh(self.head_out(x)) * cfg.max_offset

    def stacked_forward(self, windows: torch.Tensor) -> torch.Tensor:
        """Stacked arch, NCHW: windows (B, N*C, Hm, Wm) → offsets
        (B, 2, gh, gw); the head is f32 whatever the trunk's dtype."""
        x = _trunk(self, self.cfg, windows, f32_out=True)
        x = gelu(self.head_conv(x.to(torch.float32)))
        return torch.tanh(self.head_out(x)) * self.cfg.max_offset


# Standard deviation of a unit normal truncated to [-2, 2]: the reference's
# default kernel initializer divides by it so the truncated draw has
# variance 1 / fan_in.
_TRUNC_STD = 0.87962566103423978


def init_params(cfg: ModelConfig, generator: torch.Generator
                ) -> dict[str, torch.Tensor]:
    """A fresh state dict for ``MotionEstimator(cfg)`` (any arch), drawn
    from ``generator`` as the reference initializes its model: conv
    kernels truncated normal (±2 sigma) with variance 1 / fan_in, biases
    zero, GroupNorm weight one, and a zero ``head_out`` kernel, so an
    untrained model predicts zero offsets (the identity warp). The pwc
    arch's PWC-Net convs and transposed convs are drawn as NVlabs draws
    them: Kaiming normal on PyTorch's fan_in (gain sqrt(2)), biases zero;
    its head by the rule above."""
    model = MotionEstimator(cfg)
    params = {}
    for name, p in model.state_dict().items():
        if name.endswith(".bias") or name == "head_out.weight":
            params[name] = torch.zeros_like(p)
        elif p.dim() == 1:                      # GroupNorm weight
            params[name] = torch.ones_like(p)
        elif cfg.arch == "pwc" and not name.startswith("head_"):
            w = torch.empty(p.shape, dtype=p.dtype, device=generator.device)
            torch.nn.init.kaiming_normal_(w, mode="fan_in",
                                          generator=generator)
            params[name] = w.to(p.device)
        else:                                   # conv kernel, OIHW
            fan_in = p.shape[1] * p.shape[2] * p.shape[3]
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            w = torch.empty(p.shape, dtype=p.dtype, device=generator.device)
            torch.nn.init.trunc_normal_(w, std=std, a=-2.0 * std,
                                        b=2.0 * std, generator=generator)
            params[name] = w.to(p.device)
    return params


def predict_offsets(model: MotionEstimator, windows: torch.Tensor
                    ) -> torch.Tensor:
    """Apply the CNN: windows (B, Hm, Wm, N*C) → offsets (B, gh, gw, 2),
    window frame n's channel c at n*C + c."""
    cfg = model.cfg
    mh, mw = cfg.model_size
    n, c = cfg.window, cfg.channels
    if tuple(windows.shape[-3:]) != (mh, mw, n * c):
        raise ValueError(f"expected windows (*, {mh}, {mw}, {n * c}), got "
                         f"{tuple(windows.shape)}")
    x = windows.to(torch.float32)
    if cfg.arch == "stacked":
        out = model.stacked_forward(x.permute(0, 3, 1, 2).contiguous())
        return out.permute(0, 2, 3, 1)
    b = x.shape[0]
    frames = x.reshape(b, mh, mw, n, c).permute(0, 3, 1, 2, 4)
    feats = encode_frames(model, frames.reshape(b * n, mh, mw, c))
    return offsets_from_feature_windows(
        model, each(lambda f: f.reshape(b, n, *f.shape[1:]), feats))


def predict_grid(model: MotionEstimator, windows: torch.Tensor,
                 out_height: int, out_width: int) -> torch.Tensor:
    """Windows (B, Hm, Wm, N*C) → dense full-resolution sampling grids
    (B, H, W, 2): ``predict_offsets`` then ``grid_from_offsets``,
    differentiable in the model's parameters."""
    return grid_ops.grid_from_offsets(predict_offsets(model, windows),
                                      out_height, out_width)


def encode_frames(model: MotionEstimator, frames: torch.Tensor):
    """Per-frame encoder pass: frames (B, Hm, Wm, C) → features
    (B, gh, gw, F), in the compute dtype; the pwc arch gives its pyramid,
    a tuple of levels 2..6, each (B, H_l, W_l, C_l). Not the stacked arch.

    Sliding windows share window-1 of their frames, so callers encode each
    unique frame once and assemble feature windows.
    """
    global PWC_FRAMES
    if model.cfg.arch == "stacked":
        raise ValueError("feature caching requires the corr architecture "
                         "(or the pwc arch's pyramid)")
    x = frames.to(torch.float32).permute(0, 3, 1, 2).contiguous()
    if model.cfg.arch == "pwc":
        PWC_FRAMES += x.shape[0]
    return each(lambda f: f.permute(0, 2, 3, 1), model.encoder(x))


def offsets_from_feature_windows(model: MotionEstimator, feat_windows
                                 ) -> torch.Tensor:
    """Head pass over cached features: (B, N, gh, gw, F) (the pwc arch: a
    pyramid of such windows, one a level) → offsets (B, gh, gw, 2) in
    normalized units, |offset| <= max_offset."""
    feats = each(lambda f: f.permute(0, 1, 4, 2, 3).contiguous(),
                 feat_windows)
    if model.cfg.arch == "pwc":
        return model.pwc_offsets(feats).permute(0, 2, 3, 1)
    return model.head(feats).permute(0, 2, 3, 1)
