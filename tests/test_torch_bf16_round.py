"""The bf16 GELU's registered ops (ops/bf16_round.py) on the CPU: the plain
op chain, no kernel launch, fakes that give the real outputs' shape,
dtype and layout, and the ops' registration as ``torch.library`` checks
it. The chain against the reference's bf16 GELU is held in
tests/test_torch_bf16.py; the kernels against the chain in
tests/test_torch_cuda.py."""

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
