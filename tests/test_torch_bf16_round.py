"""The bf16 rounding passes' registered ops (ops/bf16_round.py) on the CPU:
GELU and the conv bias add + GroupNorm, each the plain op chain, no kernel
launch, fakes that give the real outputs' shape, dtype and layout, and the
ops' registration as ``torch.library`` checks it. The chains against the
reference's bf16 are held in tests/test_torch_bf16.py; the kernels against
the chains in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from dvsg_tpu_torch.models import motion_cnn
from dvsg_tpu_torch.ops import bf16_round

SPECIAL = [0.0, -0.0, np.inf, -np.inf, np.nan, 9.2e-41, -5e-39, 30.0,
           -30.0, 3e38, -3e38]


def _x(shape=(2, 8, 6, 5), seed=0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    z = rng.normal(0, 2.0, int(np.prod(shape))).astype(np.float32)
    z[:len(SPECIAL)] = SPECIAL
    return torch.from_numpy(z).reshape(shape).bfloat16()


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("f32_out", [False, True])
def test_gelu_op_on_the_cpu_is_the_plain_chain(f32_out):
    x = _x()
    before = bf16_round.LAUNCHES_GELU_FWD
    got = bf16_round.gelu_bf16(x, f32_out)
    want = bf16_round.gelu_plain(x, f32_out)
    assert bf16_round.LAUNCHES_GELU_FWD == before
    assert got.dtype == (torch.float32 if f32_out else torch.bfloat16)
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(motion_cnn.gelu(x, f32_out)), _bits(want))


@pytest.mark.parametrize("g_dtype", [torch.bfloat16, torch.float32])
def test_gelu_grad_op_on_the_cpu_is_the_plain_chain(g_dtype):
    """The backward op, and autograd through the model's GELU, give the
    plain chain's bits; an f32 cotangent is rounded to bf16 first."""
    x = _x()
    g = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1.0, x.shape).astype(np.float32)).to(g_dtype)
    before = bf16_round.LAUNCHES_GELU_BWD
    want = bf16_round.gelu_grad_plain(x, g)
    assert torch.equal(_bits(bf16_round.gelu_bf16_bwd(x, g)), _bits(want))
    xr = x.clone().requires_grad_()
    (gx,) = torch.autograd.grad(motion_cnn.gelu(xr, g_dtype == torch.float32),
                                xr, g)
    assert torch.equal(_bits(gx), _bits(want))
    assert bf16_round.LAUNCHES_GELU_BWD == before
    assert torch.equal(_bits(want), _bits(bf16_round.gelu_grad_plain(
        x, g.bfloat16())))


@pytest.mark.parametrize("f32_out", [False, True])
def test_gelu_op_fakes_give_the_real_outputs(f32_out):
    """Under fake tensors (as export.py traces for the card) each op gives
    the shape, dtype and strides the real op gives, channels last kept."""
    x = _x((2, 8, 6, 5)).contiguous(memory_format=torch.channels_last)
    g = torch.ones(x.shape).contiguous(memory_format=torch.channels_last)
    real = (bf16_round.gelu_bf16(x, f32_out), bf16_round.gelu_bf16_bwd(x, g))
    with FakeTensorMode() as mode:
        fx, fg = mode.from_tensor(x), mode.from_tensor(g)
        fake = (bf16_round.gelu_bf16(fx, f32_out),
                bf16_round.gelu_bf16_bwd(fx, fg))
    for r, f in zip(real, fake):
        assert (f.shape, f.dtype, f.stride()) == (r.shape, r.dtype,
                                                  r.stride())
    assert fake[0].dtype == (torch.float32 if f32_out else torch.bfloat16)
    assert fake[1].dtype == torch.bfloat16


@pytest.mark.parametrize("f32_out", [False, True])
def test_gelu_ops_pass_the_library_checks(f32_out):
    """torch.library.opcheck: schema, fake against real, and the
    dispatcher's handling of both ops (finite inputs: the checks compare
    outputs with NaN unequal to itself)."""
    x = _x((3, 4, 5))[1:]                  # the specials sit in x[0]
    torch.library.opcheck(bf16_round.gelu_bf16, (x, f32_out))
    g = torch.ones(x.shape, dtype=torch.float32 if f32_out
                   else torch.bfloat16)
    torch.library.opcheck(bf16_round.gelu_bf16_bwd, (x, g))


@pytest.mark.parametrize("layout", ["same", "g_channels_last",
                                    "x_channels_last", "x_sliced",
                                    "g_transposed", "g_permuted",
                                    "g_sliced", "size_one",
                                    "x_channels_last_g_f32"])
def test_kernel_outputs_take_the_chains_layout(layout):
    """The launchers allocate each output as the chain lays its result out
    (a later op may pick another algorithm for another layout), in every
    layout: dense or sliced, x's or g's first, a size-1 dimension, an f32
    cotangent."""
    x, g = _x((2, 16, 8, 8)), _x((2, 16, 8, 8), seed=1)
    cl = torch.channels_last
    x, g = {"same": (x, g),
            "g_channels_last": (x, g.contiguous(memory_format=cl)),
            "x_channels_last": (x.contiguous(memory_format=cl),
                                g.contiguous(memory_format=cl)),
            "x_sliced": (_x((2, 32, 8, 8))[:, ::2], g),
            "g_transposed": (x, _x((2, 8, 16, 8)).transpose(1, 2)),
            "g_permuted": (x, _x((8, 2, 8, 16)).permute(1, 3, 0, 2)),
            "g_sliced": (x, _x((2, 16, 8, 16))[..., ::2]),
            "size_one": (x[:1], _x((1, 8, 8, 16)).permute(0, 3, 1, 2)),
            "x_channels_last_g_f32": (x.contiguous(memory_format=cl),
                                      g.float()),
            }[layout]
    for f32_out in (False, True):
        want = bf16_round.gelu_plain(x, f32_out)
        got = bf16_round._empty_as_plain(bf16_round.gelu_plain, want.dtype,
                                         x, f32_out)
        assert (got.stride(), got.dtype) == (want.stride(), want.dtype)
    want = bf16_round.gelu_grad_plain(x, g)
    for _ in range(2):                    # the replay, then its record
        got = bf16_round._empty_as_plain(bf16_round.gelu_grad_plain,
                                         torch.bfloat16, x, g)
        assert (got.shape, got.stride()) == (want.shape, want.stride())


# The conv + GroupNorm shapes (C, H, W) of the bf16 trunk: the quality
# preset's four levels, the fast preset's other two, and an odd H x W.
GN_SHAPES = [(64, 128, 128), (128, 64, 64), (256, 32, 32), (256, 16, 16),
             (64, 64, 64), (128, 32, 32), (32, 7, 9)]


class _CastToF32(torch.autograd.Function):
    """One of the reference's casts of a bf16 value to f32, applied to the
    f32 sum ``y`` that XLA keeps in its place: the value is ``y``, or
    ``y`` rounded to bf16 with ``rounded``; the gradient is rounded to
    bf16, since each cast's transpose rounds its own share."""

    @staticmethod
    def forward(ctx, y, rounded):
        return y.to(torch.bfloat16).float() if rounded else y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).float(), None


class _BiasAddF32(torch.autograd.Function):
    """A bf16 conv result plus its bias cast to bf16, the sum kept f32
    (XLA fuses it into the GroupNorm's normalize); the gradient rounds to
    bf16, the bias's is the bf16 bias add's."""

    @staticmethod
    def forward(ctx, y, bias):
        return y.float() + bias.to(y.dtype).float()[:, None, None]

    @staticmethod
    def backward(ctx, g):
        g = g.to(torch.bfloat16)
        return g, bf16_round.bias_grad_bf16(g)


def _chain(x, bias, weight, beta, groups, eps):
    """The bf16 conv_norm as the model spelled it before its ops: the bias
    add kept f32, statistics of its bf16 rounding, the f32 normalize,
    one rounding; autograd through each cast's rounded share."""
    y = _BiasAddF32.apply(x, bias)
    b, c = y.shape[:2]
    g = _CastToF32.apply(y, True).reshape(b, groups, -1)
    mean = g.mean(dim=-1, keepdim=True)
    var = torch.clamp((g * g).mean(dim=-1, keepdim=True) - mean * mean,
                      min=0.0)
    y = _CastToF32.apply(y, False).reshape(b, groups, c // groups,
                                            *y.shape[2:])
    y = y - mean.reshape(b, groups, 1, 1, 1)
    y = y * (torch.rsqrt(var + eps).reshape(b, groups, 1, 1, 1)
             * weight.reshape(groups, c // groups, 1, 1))
    y = y.reshape(b, c, *y.shape[3:]) + beta.reshape(c, 1, 1)
    return y.to(x.dtype)


def _gn_case(c, h, w, seed=0, batch=1):
    """A conv_norm's bf16 input (the conv without its bias), conv bias,
    norm weight and shift, and a bf16 cotangent."""
    rng = np.random.default_rng(seed)

    def t(shape, mu, sd):
        return torch.from_numpy(rng.normal(mu, sd, shape).astype(np.float32))
    return (t((batch, c, h, w), 0.3, 2.0).bfloat16(), t(c, 0.0, 0.1),
            t(c, 1.0, 0.1), t(c, 0.0, 0.1), t((batch, c, h, w), 0.0,
                                               1.0).bfloat16())


@pytest.mark.parametrize("groups", [8, 4, 2])
@pytest.mark.parametrize("shape", GN_SHAPES, ids=lambda s: "x".join(map(
    str, s)))
def test_group_norm_op_on_the_cpu_is_the_chain(shape, groups):
    """conv_norm's bf16 GroupNorm, through its autograd function and the
    registered ops, gives the chain's bytes on the CPU: the output and the
    gradients of the conv's output and bias and of the norm's weight and
    shift. No kernel is launched."""
    x, bias, weight, beta, g = _gn_case(*shape)
    norm = torch.nn.GroupNorm(groups, shape[0], eps=motion_cnn.GN_EPS)
    before = bf16_round.LAUNCHES_GN_FWD, bf16_round.LAUNCHES_GN_BWD
    runs = []
    for op in (True, False):
        leaves = [t.clone().requires_grad_() for t in (x, bias, weight,
                                                        beta)]
        if op:
            y = motion_cnn._GroupNormBf16.apply(*leaves, groups, norm.eps)
        else:
            y = _chain(*leaves, groups, norm.eps)
        runs.append([y, *torch.autograd.grad(y, leaves, g)])
    assert (bf16_round.LAUNCHES_GN_FWD,
            bf16_round.LAUNCHES_GN_BWD) == before
    for name, got, want in zip(("out", "dx", "dbias", "dweight", "dbeta"),
                               *runs):
        assert got.dtype == want.dtype and got.stride() == want.stride()
        assert torch.equal(_bits(got), _bits(want)), name


def test_group_norm_op_statistics_are_the_chains():
    """The forward op's second output: the chain's f32 mean and E[x²] −
    mean² of each (sample, group), before the clamp."""
    x, bias, weight, beta, _ = _gn_case(32, 7, 9, batch=2)
    _, stats = bf16_round.group_norm_bf16(x, bias, weight, beta, 4, 1e-6)
    q = (x.float() + bias.bfloat16().float()[:, None, None]).bfloat16()
    q = q.float().reshape(2, 4, -1)
    mean = q.mean(dim=-1)
    assert stats.shape == (2, 4, 2) and stats.dtype == torch.float32
    assert torch.equal(stats[..., 0], mean)
    assert torch.equal(stats[..., 1], (q * q).mean(dim=-1) - mean * mean)


def test_group_norm_op_fakes_give_the_real_outputs():
    """Under fake tensors both GroupNorm ops give the shapes, dtypes and
    strides the real ops give."""
    x, bias, weight, beta, g = _gn_case(32, 8, 6, batch=2)
    fwd = (x, bias, weight, beta, 4, 1e-6)
    real = [*bf16_round.group_norm_bf16(*fwd)]
    real += bf16_round.group_norm_bf16_bwd(g, x, real[1], bias, weight, 4,
                                           1e-6)
    with FakeTensorMode() as mode:
        fx, fb, fw, fbeta, fg = (mode.from_tensor(t) for t in
                                 (x, bias, weight, beta, g))
        fake = [*bf16_round.group_norm_bf16(fx, fb, fw, fbeta, 4, 1e-6)]
        fake += bf16_round.group_norm_bf16_bwd(fg, fx, fake[1], fb, fw, 4,
                                               1e-6)
    assert len(fake) == len(real) == 6
    for r, f in zip(real, fake):
        assert (f.shape, f.dtype, f.stride()) == (r.shape, r.dtype,
                                                  r.stride())


def test_group_norm_ops_pass_the_library_checks():
    """torch.library.opcheck on both GroupNorm ops: schema, fake against
    real, the dispatcher's handling."""
    x, bias, weight, beta, g = _gn_case(16, 5, 6, batch=2)
    torch.library.opcheck(bf16_round.group_norm_bf16,
                          (x, bias, weight, beta, 4, 1e-6))
    _, stats = bf16_round.group_norm_bf16(x, bias, weight, beta, 4, 1e-6)
    torch.library.opcheck(bf16_round.group_norm_bf16_bwd,
                          (g, x, stats, bias, weight, 4, 1e-6))


def test_conv_norm_takes_the_group_norm_op():
    """A bf16 conv_norm calls the forward op once and, under autograd, the
    backward op once; an f32 one calls neither."""
    conv = motion_cnn.SameConv2d(16, 16, 3)
    norm = motion_cnn._group_norm(16)
    calls = []
    ops = {name: getattr(bf16_round, name) for name in
           ("group_norm_bf16", "group_norm_bf16_bwd")}
    try:
        for name, op in ops.items():
            setattr(bf16_round, name,
                    lambda *a, _n=name, _op=op: calls.append(_n) or _op(*a))
        x = torch.randn(2, 16, 8, 8)
        motion_cnn.conv_norm(conv, norm, x).sum().backward()
        assert calls == []
        xb = x.bfloat16().requires_grad_()
        motion_cnn.conv_norm(conv, norm, xb).float().sum().backward()
    finally:
        for name, op in ops.items():
            setattr(bf16_round, name, op)
    assert calls == ["group_norm_bf16", "group_norm_bf16_bwd"]
    assert xb.grad.dtype == torch.bfloat16
