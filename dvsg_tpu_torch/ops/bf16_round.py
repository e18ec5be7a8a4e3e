"""The bf16 trunk's rounding passes as kernels: GELU and the conv bias +
GroupNorm, each forward and backward.

With ``ModelConfig.dtype == "bfloat16"`` the reference (flax on XLA) runs
``jax.nn.gelu`` (tanh form) on bf16 arrays, rounding every op's result to
bf16 with its constants rounded to bf16 first, and takes the gradient by
JAX's JVP transposed, op by op, in the order of XLA's fusion. The plain
version here spells both chains out as PyTorch ops (``gelu_plain``,
``gelu_grad_plain``): bit-equal to the reference on the CPU, and on the
card one kernel and one trip through device memory per op, 9 forward and
21 backward.

A bf16 conv's bias add and the GroupNorm after it are a second chain
(``group_norm_bf16_plain``; ``group_norm_bf16_grad_plain``, the gradient
autograd takes through it, op by op): the bias
added in f32, flax's f32 statistics of the sum rounded to bf16 (mean and
E[x²] − mean², clamped at 0), the f32 normalize of the unrounded sum,
one rounding; backward, each of the two casts to f32 rounds its share of
the gradient to bf16 before they add, and the sum is rounded again. On
the card that was about 25 f32 kernels forward and as many backward a
call.

The kernels of ``csrc/bf16_round.cu`` replace no Pallas kernel: they do
what XLA's fusion does on the TPU, each chain in one pass with every
rounding in registers. The GELU kernels are byte-equal to the plain
version on the card. Their bound is memory: 4 bytes an element forward
(x in, y out) and 6 backward (x and g in, dx out). The GroupNorm kernels
keep every bf16 rounding of the chain but take the statistics and the
gradient's reductions in their own fixed order (the statistics in f64,
the gradient's sums in f32 within 8 values and f64 above), so they are
deterministic and the statistics are float64 ones rounded once; their
outputs sit within an ulp of the chain's. A
thread-block cluster holds a (sample, group) in shared memory: 4 bytes
an element forward (x in, y out), 6 backward (x and g in, dx out).

The ops are registered, ``torch.ops.dvsg_torch.gelu_bf16(x, f32_out)``,
``gelu_bf16_bwd(x, g)``, ``group_norm_bf16(x, bias, weight, beta,
groups, eps)`` and ``group_norm_bf16_bwd(g, x, stats, bias, weight,
groups, eps)``, so that ``torch.export`` records them in an exported bf16
chunk step (export.py), where a ctypes launch could not be traced. A CUDA
tensor launches the kernel (or raises); a CPU tensor runs the plain
version.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from dvsg_tpu_torch.utils.metrics import span

# Kernel launches in this process (a run reads them before and after to
# show its main path went through the kernels): one a call of each op.
LAUNCHES_GELU_FWD = 0
LAUNCHES_GELU_BWD = 0
LAUNCHES_GN_FWD = 0
LAUNCHES_GN_BWD = 0


def bf16(v: float) -> float:
    """``v`` rounded to bf16: what a weakly typed constant becomes against
    a bf16 array in the reference."""
    return float(torch.tensor(v, dtype=torch.bfloat16))


GELU_CUBE = bf16(0.044715)
GELU_SQRT_2_PI = bf16(math.sqrt(2.0 / math.pi))


def _gelu_gate_plain(x: torch.Tensor) -> tuple:
    """(x², tanh of the inner term, the gate 0.5 (1 + tanh)) of
    jax.nn.gelu's formula in its order, each op rounded to bf16."""
    x2 = x * x
    t = torch.tanh(GELU_SQRT_2_PI * (x + GELU_CUBE * (x2 * x)))
    return x2, t, 0.5 * (1.0 + t)


def gelu_plain(x: torch.Tensor, f32_out: bool = False) -> torch.Tensor:
    """jax.nn.gelu on bf16 ``x``, each op rounded. With ``f32_out`` the last
    product stays f32: where the reference casts a GELU's bf16 result to
    f32, XLA drops that rounding."""
    h = _gelu_gate_plain(x)[2]
    return x.float() * h.float() if f32_out else x * h


def gelu_grad_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The gradient JAX derives for ``gelu_plain`` at bf16 ``x`` for the
    cotangent ``g`` (rounded to bf16 first): its JVP transposed, each op
    rounded, in the order of XLA's fusion."""
    g = g.to(x.dtype)
    x2, t, h = _gelu_gate_plain(x)
    q = ((x * g) * 0.5) * (1.0 - t)
    ga = (q + q * t) * GELU_SQRT_2_PI      # through tanh, sqrt(2/pi)
    return (g * h + ga) + (ga * GELU_CUBE) * (x2 * 3.0)


def bias_grad_bf16(g: torch.Tensor) -> torch.Tensor:
    """The bias gradient of a bf16 bias add, NCHW ``g`` → (C,) f32.

    XLA's CPU backend (the reference on the CPU) sums a bf16 reduction
    sequentially in bf16, rows in NHWC order, rounding after every add;
    that is copied here. On the card the sum runs in f32 and rounds once
    (a serial scan there would cost one launch per row)."""
    if g.is_cuda:
        return g.sum(dim=(0, 2, 3)).float()
    acc = torch.zeros(g.shape[1], dtype=g.dtype)
    for row in g.permute(0, 2, 3, 1).reshape(-1, g.shape[1]):
        acc = acc + row
    return acc.float()


class BiasAddBf16(torch.autograd.Function):
    """``y + bias`` of a bf16 conv result ``y`` and the bias cast to bf16,
    rounded to bf16. The gradient rounds to bf16, as the reference's bf16
    add does, and the bias's is ``bias_grad_bf16``."""

    @staticmethod
    def forward(ctx, y, bias):
        with span("bf16_round"):
            return y + bias.to(y.dtype)[:, None, None]

    @staticmethod
    def backward(ctx, g):
        with span("bf16_round"):
            g = g.to(torch.bfloat16)
            return g, bias_grad_bf16(g)


def group_norm_bf16_plain(x: torch.Tensor, bias: torch.Tensor,
                          weight: torch.Tensor, beta: torch.Tensor,
                          groups: int, eps: float) -> tuple:
    """A bf16 conv's bias add and GroupNorm as the reference computes
    them, op by op: bf16 NCHW ``x`` (the conv without its bias), the f32
    conv ``bias``, the norm's f32 ``weight`` and ``beta`` → (the bf16
    output, (B, groups, 2) f32 statistics: mean and E[x²] − mean² before
    the clamp).

    flax's f32 statistics (mean and E[x²] − mean², clamped at 0) of the
    bf16 conv output, then f32 normalize, scale and shift, one rounding to
    bf16. XLA fuses the conv's bias add into the normalize and keeps that
    sum in f32 there (the statistics read it rounded), so this does too."""
    b, c = x.shape[:2]
    y = x.float() + bias.to(x.dtype).float()[:, None, None]
    q = y.to(torch.bfloat16).float().reshape(b, groups, -1)
    mean = q.mean(dim=-1, keepdim=True)
    var = (q * q).mean(dim=-1, keepdim=True) - mean * mean
    stats = torch.cat([mean, var], dim=-1)
    var = torch.clamp(var, min=0.0)
    y = y.reshape(b, groups, c // groups, *y.shape[2:])
    y = y - mean.reshape(b, groups, 1, 1, 1)
    y = y * (torch.rsqrt(var + eps).reshape(b, groups, 1, 1, 1)
             * weight.reshape(groups, c // groups, 1, 1))
    y = y.reshape(b, c, *y.shape[3:]) + beta.reshape(c, 1, 1)
    return y.to(x.dtype), stats


def group_norm_bf16_grad_plain(g: torch.Tensor, x: torch.Tensor,
                               stats: torch.Tensor, bias: torch.Tensor,
                               weight: torch.Tensor, groups: int,
                               eps: float) -> tuple:
    """The gradients of ``group_norm_bf16_plain``'s output for the bf16
    cotangent ``g``: (x's bf16, bias's, weight's and beta's f32), as
    autograd takes them through the chain, op by op and in its order of
    accumulation (sums reduce a broadcast operand's gradient, the engine
    adds the shares of a value used twice in the order its nodes run).
    Each of the chain's two reads of the bias add's f32 sum (the
    statistics' rounded, the normalize's exact) rounds its share of the
    gradient to bf16, and the bias add's transpose rounds their sum.
    The chain recomputes its statistics, so ``stats`` (the backward op's
    argument) goes unread; the norm's shift adds last, so no gradient
    reads it."""
    b, c = x.shape[:2]
    cpg, rest = c // groups, x.shape[2:]
    y = x.float() + bias.to(x.dtype).float()[:, None, None]
    q = y.to(torch.bfloat16).float().reshape(b, groups, -1)
    n = q.shape[-1]
    mean = q.mean(dim=-1, keepdim=True)
    var = (q * q).mean(dim=-1, keepdim=True) - mean * mean
    r = torch.rsqrt(torch.clamp(var, min=0.0) + eps)
    r5 = r.reshape(b, groups, 1, 1, 1)
    w4 = weight.reshape(groups, cpg, 1, 1)
    go = g.float()
    dbeta = go.sum(dim=(0, 2, 3), keepdim=True).reshape(c)
    ge = go.reshape(b, groups, cpg, *rest)
    dd = ge * (r5 * w4)                        # the normalize's share
    ds = (ge * (y.reshape(b, groups, cpg, *rest)
                - mean.reshape(b, groups, 1, 1, 1))).sum(dim=(3, 4),
                                                         keepdim=True)
    dweight = (ds * r5).sum(dim=0, keepdim=True).reshape(c)
    dr = (ds * w4).sum(dim=2, keepdim=True).reshape(b, groups, 1)
    dvar = torch.where(var >= 0, (-0.5 * dr) * r.pow(3), 0.0)
    dmm = -dvar * mean
    dmean = ((-dd).sum(dim=(2, 3, 4), keepdim=True).reshape(b, groups, 1)
             + dmm) + dmm
    t = (dvar.expand(b, groups, n) / n) * q
    dq = (t + t) + dmean.expand(b, groups, n) / n  # the statistics' share
    dx = (dd.reshape(x.shape).to(torch.bfloat16).float()
          + dq.reshape(x.shape).to(torch.bfloat16).float()).to(x.dtype)
    return dx, bias_grad_bf16(dx), dweight, dbeta


@functools.cache
def _kernels():
    """The C launchers of csrc/bf16_round.cu (built at first use):
    (forward, backward)."""
    from dvsg_tpu_torch.ops import _build
    lib = _build.library("bf16_round")
    fwd, bwd = lib.dvsg_gelu_bf16_fwd, lib.dvsg_gelu_bf16_bwd
    fwd.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int] \
        + [ctypes.c_float] * 2 + [ctypes.c_void_p]
    bwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int] \
        + [ctypes.c_float] * 2 + [ctypes.c_void_p]
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


@functools.cache
def _gn_kernels():
    """The GroupNorm's C launchers of csrc/bf16_round.cu: (units a group
    for the backward's partial sums, forward, backward)."""
    from dvsg_tpu_torch.ops import _build
    lib = _build.library("bf16_round")
    units = lib.dvsg_group_norm_bf16_units
    fwd, bwd = lib.dvsg_group_norm_bf16_fwd, lib.dvsg_group_norm_bf16_bwd
    shape = [ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_float,
                                       ctypes.c_void_p]
    units.argtypes = [ctypes.c_longlong] * 2 + [ctypes.c_int]
    fwd.argtypes = [ctypes.c_void_p] * 6 + shape
    bwd.argtypes = [ctypes.c_void_p] * 10 + shape
    units.restype = fwd.restype = bwd.restype = ctypes.c_int
    return units, fwd, bwd


@functools.cache
def _gn_units(c: int, hw: int, groups: int) -> int:
    """Units a (sample, group) for the backward's partial sums (3 doubles
    a unit), asked of the launcher once per shape."""
    return _gn_kernels()[0](c, hw, groups)


# The strides of the chain's result for each (chain, shapes, strides, dtypes,
# flags) met so far: a step makes 42 of these calls on a handful of layouts,
# and a replay is 9 or 21 dispatcher calls on the host.
_CHAIN_STRIDES: dict = {}


def _empty_as_plain(plain, dtype: torch.dtype, x: torch.Tensor,
                    *rest) -> torch.Tensor:
    """An empty ``dtype`` tensor on ``x``'s device laid out as
    ``plain(x, *rest)``'s result: the chain replayed on the meta device on
    inputs of the same strides, once per layout. A later op can take
    another algorithm for another layout, so the kernels keep the
    chain's."""
    args = (x, *rest)
    key = (plain, *((a.shape, a.stride(), a.dtype)
                    if isinstance(a, torch.Tensor) else a for a in args))
    stride = _CHAIN_STRIDES.get(key)
    if stride is None:
        meta = plain(*(torch.empty_strided(a.shape, a.stride(),
                                           dtype=a.dtype, device="meta")
                       if isinstance(a, torch.Tensor) else a for a in args))
        stride = _CHAIN_STRIDES[key] = meta.stride()
    return torch.empty_strided(x.shape, stride, dtype=dtype, device=x.device)


def _as(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` itself where it has ``like``'s strides, else a copy in them."""
    if t.stride() == like.stride():
        return t
    return torch.empty_like(like, dtype=t.dtype).copy_(t)


def _check(x: torch.Tensor) -> None:
    if x.dtype != torch.bfloat16:
        raise ValueError(f"x must be bf16, got {x.dtype}")


def _launch_fwd(x: torch.Tensor, f32_out: bool) -> torch.Tensor:
    global LAUNCHES_GELU_FWD
    _check(x)
    y = _empty_as_plain(gelu_plain, torch.float32 if f32_out
                        else torch.bfloat16, x, f32_out)
    x = _as(x, y)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = _kernels()[0](x.data_ptr(), y.data_ptr(), x.numel(),
                           int(f32_out), GELU_CUBE, GELU_SQRT_2_PI, stream)
    if rc != 0:
        raise RuntimeError(f"gelu_bf16 forward kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES_GELU_FWD += 1
    return y


def _launch_bwd(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    global LAUNCHES_GELU_BWD
    _check(x)
    if g.shape != x.shape or g.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"g must be bf16 or f32 of x's shape {tuple(x.shape)}"
                         f", got {g.dtype} {tuple(g.shape)}")
    if g.device != x.device:
        raise ValueError(f"x on {x.device} but g on {g.device}")
    dx = _empty_as_plain(gelu_grad_plain, torch.bfloat16, x, g)
    x, g = _as(x, dx), _as(g, dx)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = _kernels()[1](x.data_ptr(), g.data_ptr(), dx.data_ptr(),
                           x.numel(), int(g.dtype == torch.float32),
                           GELU_CUBE, GELU_SQRT_2_PI, stream)
    if rc != 0:
        raise RuntimeError(f"gelu_bf16 backward kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES_GELU_BWD += 1
    return dx


def _check_gn(x: torch.Tensor, params, groups: int) -> None:
    """What the GroupNorm kernels take: bf16 ``x`` NCHW and dense (as
    cuDNN returns a conv), f32 dense (C,) parameters on its device, a
    group count that divides C."""
    if x.dtype != torch.bfloat16 or x.dim() != 4:
        raise ValueError(f"x must be 4-D bf16, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"x must be NCHW contiguous, got strides "
                         f"{x.stride()}")
    c = x.shape[1]
    if groups < 1 or c % groups:
        raise ValueError(f"{groups} groups do not divide {c} channels")
    for p in params:
        if (p.dtype != torch.float32 or tuple(p.shape) != (c,)
                or not p.is_contiguous() or p.device != x.device):
            raise ValueError(f"parameters must be dense f32 ({c},) on "
                             f"{x.device}, got {p.dtype} {tuple(p.shape)} "
                             f"on {p.device}")


def _launch_gn_fwd(x: torch.Tensor, bias: torch.Tensor,
                   weight: torch.Tensor, beta: torch.Tensor, groups: int,
                   eps: float) -> tuple:
    global LAUNCHES_GN_FWD
    _check_gn(x, (bias, weight, beta), groups)
    b, c, h, w = x.shape
    y = torch.empty_like(x)
    stats = torch.empty((b, groups, 2), dtype=torch.float32,
                        device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = _gn_kernels()[1](x.data_ptr(), bias.data_ptr(),
                              weight.data_ptr(), beta.data_ptr(),
                              y.data_ptr(), stats.data_ptr(), b, c, h * w,
                              groups, eps, stream)
    if rc != 0:
        raise RuntimeError(f"group_norm_bf16 forward kernel launch failed: "
                           f"CUDA error {rc}")
    LAUNCHES_GN_FWD += 1
    return y, stats


def _launch_gn_bwd(g: torch.Tensor, x: torch.Tensor, stats: torch.Tensor,
                   bias: torch.Tensor, weight: torch.Tensor, groups: int,
                   eps: float) -> tuple:
    global LAUNCHES_GN_BWD
    _check_gn(x, (bias, weight), groups)
    b, c, h, w = x.shape
    if g.dtype != torch.bfloat16 or g.shape != x.shape or g.device != x.device:
        raise ValueError(f"g must be bf16 of x's shape {tuple(x.shape)} on "
                         f"{x.device}, got {g.dtype} {tuple(g.shape)} on "
                         f"{g.device}")
    if (stats.dtype != torch.float32 or tuple(stats.shape) != (b, groups, 2)
            or not stats.is_contiguous() or stats.device != x.device):
        raise ValueError(f"stats must be dense f32 ({b}, {groups}, 2), got "
                         f"{stats.dtype} {tuple(stats.shape)}")
    g = g.contiguous()      # a channels-last cotangent: copied to NCHW
    partial = torch.empty(b * groups * _gn_units(c, h * w, groups) * 3,
                          dtype=torch.float64, device=x.device)
    dx = torch.empty_like(x)
    dbias, dweight, dbeta = (torch.empty(c, dtype=torch.float32,
                                         device=x.device) for _ in range(3))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = _gn_kernels()[2](
            g.data_ptr(), x.data_ptr(), stats.data_ptr(), bias.data_ptr(),
            weight.data_ptr(), dx.data_ptr(), partial.data_ptr(),
            dbias.data_ptr(), dweight.data_ptr(), dbeta.data_ptr(), b, c,
            h * w, groups, eps, stream)
    if rc != 0:
        raise RuntimeError(f"group_norm_bf16 backward kernel launch failed: "
                           f"CUDA error {rc}")
    LAUNCHES_GN_BWD += 1
    return dx, dbias, dweight, dbeta


# The ops are defined with torch.library's plain calls, not custom_op:
# custom_op's kernels import torch._dynamo at their first call, ~3 s of a
# bf16 training run's set-up, which calls no other registered op.
_LIB = torch.library.Library("dvsg_torch", "FRAGMENT")
_LIB.define("gelu_bf16(Tensor x, bool f32_out) -> Tensor")
_LIB.define("gelu_bf16_bwd(Tensor x, Tensor g) -> Tensor")
_LIB.define("group_norm_bf16(Tensor x, Tensor bias, Tensor weight, "
            "Tensor beta, int groups, float eps) -> (Tensor, Tensor)")
_LIB.define("group_norm_bf16_bwd(Tensor g, Tensor x, Tensor stats, "
            "Tensor bias, Tensor weight, int groups, float eps) -> "
            "(Tensor, Tensor, Tensor, Tensor)")


def _gelu_bf16_cpu(x: torch.Tensor, f32_out: bool) -> torch.Tensor:
    return gelu_plain(x, f32_out)


def _gelu_bf16_cuda(x: torch.Tensor, f32_out: bool) -> torch.Tensor:
    return _launch_fwd(x, f32_out)


def _gelu_bf16_bwd_cpu(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return gelu_grad_plain(x, g)


def _gelu_bf16_bwd_cuda(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return _launch_bwd(x, g)


_LIB.impl("gelu_bf16", _gelu_bf16_cpu, "CPU")
_LIB.impl("gelu_bf16", _gelu_bf16_cuda, "CUDA")
_LIB.impl("gelu_bf16_bwd", _gelu_bf16_bwd_cpu, "CPU")
_LIB.impl("gelu_bf16_bwd", _gelu_bf16_bwd_cuda, "CUDA")


# The CUDA kernels look their launchers up at each call, so that a run can
# swap them for the chain (chip_smoke.py's kernel-against-plain step).
def _gn_bf16_cuda(x, bias, weight, beta, groups: int, eps: float):
    return _launch_gn_fwd(x, bias, weight, beta, groups, eps)


def _gn_bf16_bwd_cuda(g, x, stats, bias, weight, groups: int, eps: float):
    return _launch_gn_bwd(g, x, stats, bias, weight, groups, eps)


_LIB.impl("group_norm_bf16", group_norm_bf16_plain, "CPU")
_LIB.impl("group_norm_bf16", _gn_bf16_cuda, "CUDA")
_LIB.impl("group_norm_bf16_bwd", group_norm_bf16_grad_plain, "CPU")
_LIB.impl("group_norm_bf16_bwd", _gn_bf16_bwd_cuda, "CUDA")


# The fakes run the chain on fake tensors: the real ops' shape, dtype and
# layout on either device.
torch.library.register_fake("dvsg_torch::gelu_bf16", gelu_plain, lib=_LIB)
torch.library.register_fake("dvsg_torch::gelu_bf16_bwd", gelu_grad_plain,
                            lib=_LIB)


# Both GroupNorm ops give dense outputs on either device.
def _gn_bf16_fake(x, bias, weight, beta, groups: int, eps: float):
    return (x.new_empty(x.shape),
            x.new_empty((x.shape[0], groups, 2), dtype=torch.float32))


def _gn_bf16_bwd_fake(g, x, stats, bias, weight, groups: int, eps: float):
    return (x.new_empty(x.shape), *(weight.new_empty(weight.shape)
                                    for _ in range(3)))


torch.library.register_fake("dvsg_torch::group_norm_bf16", _gn_bf16_fake,
                            lib=_LIB)
torch.library.register_fake("dvsg_torch::group_norm_bf16_bwd",
                            _gn_bf16_bwd_fake, lib=_LIB)


# bf16 ``x`` → GELU rounded as the reference rounds (f32 with ``f32_out``),
# and bf16 ``x`` with its cotangent ``g`` (bf16 or f32) → the bf16 gradient:
# the kernels as ops of the dispatcher, the plain version on the CPU.
gelu_bf16 = torch.ops.dvsg_torch.gelu_bf16
gelu_bf16_bwd = torch.ops.dvsg_torch.gelu_bf16_bwd

# bf16 ``x`` (a conv without its bias), the conv's bias, the norm's weight
# and shift, the group count and eps → (the bf16 GroupNorm of x + bias,
# (B, groups, 2) f32 mean and unclamped variance); the bf16 cotangent, x,
# those statistics, the bias and weight → (x's bf16 gradient, the bias's,
# weight's and shift's f32 ones). The kernels on the card, the chain on the
# CPU.
group_norm_bf16 = torch.ops.dvsg_torch.group_norm_bf16
group_norm_bf16_bwd = torch.ops.dvsg_torch.group_norm_bf16_bwd
