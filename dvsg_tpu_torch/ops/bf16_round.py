"""The bf16 trunk's rounding passes as kernels: GELU forward and backward.

With ``ModelConfig.dtype == "bfloat16"`` the reference (flax on XLA) runs
``jax.nn.gelu`` (tanh form) on bf16 arrays, rounding every op's result to
bf16 with its constants rounded to bf16 first, and takes the gradient by
JAX's JVP transposed, op by op, in the order of XLA's fusion. The plain
version here spells both chains out as PyTorch ops (``gelu_plain``,
``gelu_grad_plain``): bit-equal to the reference on the CPU, and on the
card one kernel and one trip through device memory per op, 9 forward and
21 backward.

The kernels of ``csrc/bf16_round.cu`` replace no Pallas kernel: they do
what XLA's fusion does on the TPU, each chain in one pass with every
rounding in registers, byte-equal to the plain version on the card. Their
bound is memory: 4 bytes an element forward (x in, y out) and 6 backward
(x and g in, dx out).

Both are registered ops, ``torch.ops.dvsg_torch.gelu_bf16(x, f32_out)``
and ``torch.ops.dvsg_torch.gelu_bf16_bwd(x, g)``, so that ``torch.export``
records them in an exported bf16 chunk step (export.py), where a ctypes
launch could not be traced. A CUDA tensor launches the kernel (or
raises); a CPU tensor runs the plain version.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

# Kernel launches in this process (a run reads them before and after to
# show its main path went through the kernels).
LAUNCHES_GELU_FWD = 0
LAUNCHES_GELU_BWD = 0


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


# The ops are defined with torch.library's plain calls, not custom_op:
# custom_op's kernels import torch._dynamo at their first call, ~3 s of a
# bf16 training run's set-up, which calls no other registered op.
_LIB = torch.library.Library("dvsg_torch", "FRAGMENT")
_LIB.define("gelu_bf16(Tensor x, bool f32_out) -> Tensor")
_LIB.define("gelu_bf16_bwd(Tensor x, Tensor g) -> Tensor")


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


# The fakes run the chain on fake tensors: the real ops' shape, dtype and
# layout on either device.
torch.library.register_fake("dvsg_torch::gelu_bf16", gelu_plain, lib=_LIB)
torch.library.register_fake("dvsg_torch::gelu_bf16_bwd", gelu_grad_plain,
                            lib=_LIB)


# bf16 ``x`` → GELU rounded as the reference rounds (f32 with ``f32_out``),
# and bf16 ``x`` with its cotangent ``g`` (bf16 or f32) → the bf16 gradient:
# the kernels as ops of the dispatcher, the plain version on the CPU.
gelu_bf16 = torch.ops.dvsg_torch.gelu_bf16
gelu_bf16_bwd = torch.ops.dvsg_torch.gelu_bf16_bwd
