"""bf16 compute (``ModelConfig.dtype="bfloat16"``) of the port against the
JAX package on the CPU.

A bf16 model cannot be held within 1 LSB of an f32 one: the reference's
own bf16 offsets sit up to ~1e-3 normalized units from its f32 offsets.
So the port's bf16 is held to the reference's bf16, measured against the
reference's own bf16-to-f32 gap on the same input and weights.

Each rounding point of the reference, forward and backward, is copied
(models/motion_cnn.py; found in the HLO that XLA compiles for
``predict_offsets`` and for ``jax.value_and_grad(loss_fn)``) and held
block by block below, exactly where PyTorch computes in the same order.
What cannot be copied is the order of the f32 sums inside a convolution
and a GroupNorm: they make a small share of a layer's bf16 values land
one ulp apart, and bf16 rounding carries each such ulp on, layer by layer.
The whole model is held at a share of the gap, with a witness that reads
the share that sum order alone makes: the port against itself with
oneDNN's convolutions turned off.

The training step is fed one batch, rendered by the port, on both sides:
rendering is f32 (held by the f32 parity tests), and an f32 ulp of an
input pixel flips its bf16 rounding, which the step then amplifies. A
bias gradient is a sequential bf16 sum over every pixel of the batch
(``bf16_round.bias_grad_bf16``), so one ulp anywhere upstream moves it;
its worst element is printed, not held (PERF.md §7), and the median
tensor is.
"""

import dataclasses
import functools
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvsg_tpu.config import ModelConfig as JModelConfig
from dvsg_tpu.config import StabilizeConfig as JStabilizeConfig
from dvsg_tpu.config import TrainConfig as JTrainConfig
from dvsg_tpu.models import motion_cnn as jcnn
from dvsg_tpu.ops import warp as jwarp
from dvsg_tpu.pipeline.stabilize import Stabilizer as JStabilizer
from dvsg_tpu.train import loop as jloop
from dvsg_tpu.train import synthetic as jsyn
from dvsg_tpu.utils import checkpoint as jckpt
from dvsg_tpu_torch import export as texport
from dvsg_tpu_torch.config import ModelConfig, StabilizeConfig, TrainConfig
from dvsg_tpu_torch.models import motion_cnn as tcnn
from dvsg_tpu_torch.pipeline import stabilize as tstab
from dvsg_tpu_torch.train import loop as tloop
from dvsg_tpu_torch.utils import checkpoint as tckpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF = jnp.bfloat16
# The port's bf16 offsets from the reference's bf16, over the reference's
# own bf16-to-f32 gap: measured 0.569 and 0.787 at full width, where the
# witness reads 0.567 and 0.768; narrow 0.496 (witness 0.496) and 0.263
# (0.311).
GAP_SHARE = 0.9
# One bf16 loss step on one batch: the loss, and the median over the
# parameter tensors of each one's largest gradient difference, over the
# gap (readings in test_loss_and_gradients_within_a_share_of_the_gap:
# medians 0.724, 0.490, 0.083, 0.271; an f32 step reads 1.0).
LOSS_SHARE, GRAD_MEDIAN_SHARE = 0.5, 0.85
NARROW = dict(window=3, model_size=(32, 32), grid_size=(8, 8),
              base_features=8, blocks_per_level=1, max_offset=0.15)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(params):
    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.array(v)
            for path, v in leaves}


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf16_torch(a: np.ndarray) -> torch.Tensor:
    """numpy → a bf16 tensor holding the reference's bf16 rounding."""
    return torch.from_numpy(_f32(jnp.asarray(a).astype(BF)).copy()
                            ).bfloat16()


def _bf16_ulps(got: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """|got - ref| in bf16 ulps at ref's magnitude."""
    exp = np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -126)))
    return np.abs(got - ref) / 2.0 ** (exp - 7)


def _jax_draws(keys, cfg):
    """The draws the reference's _sample_batch makes from ``keys``
    (tests/test_torch_train.py): stills, paths, gains."""
    clip_len = cfg.model.window + jloop._STEPS_PER_CLIP - 1
    fold = lambda i: jax.vmap(lambda k: jax.random.fold_in(k, i))(keys)
    stills = jloop._draw_stills(fold(0), cfg, None)
    paths = jax.vmap(
        lambda k: jsyn.random_camera_path(k, clip_len))(fold(1))
    gains = 1.0 + 0.03 * jax.vmap(lambda k: jax.random.uniform(
        k, (clip_len,), minval=-1.0, maxval=1.0))(fold(2))
    return tuple(torch.from_numpy(np.array(a))
                 for a in (stills, paths, gains))


def _port(sd, cfg: ModelConfig):
    model = tcnn.MotionEstimator(cfg)
    model.load_state_dict(sd)
    return model.eval()


def _preset(name):
    params, jcfg = jckpt.load_npz(os.path.join(ROOT, "checkpoints",
                                               name + ".npz"))
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    return params, jcfg, tckpt.params_from_flax(_flat(params), cfg), cfg


def _shaky_windows(cfg, n_out: int, seed: int) -> np.ndarray:
    """Model-input windows (n_out, mh, mw, N*C) of a synthetic shaky clip
    at model resolution, centred at 0 as the pipeline feeds them."""
    mh, mw = cfg.model_size
    n = cfg.window
    frames, _, _ = jsyn.synthetic_clip_u8(jax.random.key(seed),
                                          n_out + n - 1, mh, mw)
    seq = np.asarray(frames, np.float32) / 255.0 - 0.5
    return np.stack([np.concatenate(list(seq[t:t + n]), axis=-1)
                     for t in range(n_out)])


def _offsets_share(jcfg, params, model, windows) -> tuple:
    """(port's bf16 error, reference's bf16-to-f32 gap, witness), max abs
    over the offsets of ``windows``; the witness is the port with
    oneDNN's convolutions off against the port: what a change of the f32
    sum order alone makes."""
    jb = dataclasses.replace(jcfg, dtype="bfloat16")
    w = jnp.asarray(windows)
    f32 = np.asarray(jax.jit(lambda p, v: jcnn.predict_offsets(jcfg, p, v))(
        params, w))
    b16 = np.asarray(jax.jit(lambda p, v: jcnn.predict_offsets(jb, p, v))(
        params, w))
    with torch.no_grad():
        ours = tcnn.predict_offsets(model, torch.from_numpy(windows)).numpy()
        with torch.backends.mkldnn.flags(enabled=False):
            other = tcnn.predict_offsets(model, torch.from_numpy(windows))
    return (float(np.abs(ours - b16).max()), float(np.abs(b16 - f32).max()),
            float(np.abs(other.numpy() - ours).max()))


# --- rounding points, held exactly or at their measured share --------------

def test_gelu_rounds_as_the_reference():
    """jax.nn.gelu on bf16 rounds after every op, with bf16 constants."""
    z = np.random.default_rng(0).normal(0, 2.0, 1 << 16).astype(np.float32)
    ref = _f32(jax.jit(jax.nn.gelu)(jnp.asarray(z).astype(BF)))
    ours = tcnn.gelu(_bf16_torch(z)).float().numpy()
    np.testing.assert_array_equal(ours, ref)
    fused = torch.nn.functional.gelu(_bf16_torch(z), approximate="tanh")
    assert (fused.float().numpy() != ref).mean() > 0.1   # one rounding


@pytest.mark.parametrize("k,stride", [(7, 1), (3, 2), (3, 1)])
def test_conv_rounds_before_its_bias_as_the_reference(k, stride):
    rng = np.random.default_rng(k + stride)
    x = rng.uniform(-1, 1, (2, 32, 32, 16)).astype(np.float32)
    p = {"kernel": (rng.standard_normal((k, k, 16, 24)) * 0.1).astype(
        np.float32), "bias": rng.standard_normal(24).astype(np.float32)}
    conv = fnn.Conv(24, (k, k), strides=(stride, stride), padding="SAME",
                    dtype=BF)
    ref = _f32(jax.jit(lambda p_, v: conv.apply({"params": p_}, v))(
        p, jnp.asarray(x).astype(BF)))
    ours = tcnn.SameConv2d(16, 24, k, stride)
    ours.weight.data = torch.from_numpy(p["kernel"].transpose(3, 2, 0, 1)
                                        .copy())
    ours.bias.data = torch.from_numpy(p["bias"])
    with torch.no_grad():
        got = ours(_bf16_torch(x).permute(0, 3, 1, 2)).float()
    got = got.permute(0, 2, 3, 1).numpy()
    # The f32 sums inside the conv run in another order: 1 value in 49152
    # measured one ulp apart (7x7), none for the 3x3 convs.
    assert (got != ref).mean() <= 1e-4 and _bf16_ulps(got, ref).max() <= 1


def _vjp_bf16(fn, params, x: np.ndarray, ct: np.ndarray):
    """The reference's jitted vjp of ``fn(params, x)`` at bf16 ``x`` with
    the cotangent ``ct`` (cast to ``ct``'s bf16 or kept f32)."""
    f = jax.jit(lambda p, v, c: jax.vjp(fn, p, v)[1](c))
    return f(params, jnp.asarray(x).astype(BF), ct)


def _share(got, ref) -> float:
    return float((np.asarray(got, np.float32) != np.asarray(ref, np.float32)
                  ).mean())


def _rel(got, ref) -> float:
    ref = np.asarray(ref, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - ref).max()
                 / np.abs(ref).max())


def test_gelu_gradient_as_the_reference():
    """JAX's GELU gradient on bf16: its JVP transposed, every op rounded,
    bit for bit (a PyTorch autograd of the forward ops differs on 27 %)."""
    rng = np.random.default_rng(1)
    z = rng.normal(0, 2.0, 1 << 16).astype(np.float32)
    g = rng.normal(0, 1.0, z.shape).astype(np.float32)
    _, ref = _vjp_bf16(lambda _, v: jax.nn.gelu(v), {}, z,
                       jnp.asarray(g).astype(BF))
    x = _bf16_torch(z).requires_grad_()
    tcnn.gelu(x).backward(_bf16_torch(g))
    np.testing.assert_array_equal(x.grad.float().numpy(), _f32(ref))


def _torch_conv(p, cin, cout, k, stride=1):
    conv = tcnn.SameConv2d(cin, cout, k, stride)
    conv.weight.data = torch.from_numpy(p["kernel"].transpose(3, 2, 0, 1)
                                        .copy())
    conv.bias.data = torch.from_numpy(p["bias"])
    return conv


@pytest.mark.parametrize("k,stride", [(7, 1), (3, 2), (3, 1)])
def test_conv_gradients_as_the_reference(k, stride):
    """A bf16 conv's gradients: the input's rounded to bf16 (f32 sums in
    another order: measured 0.0031-0.0214 % one ulp apart), the kernel's
    f32 as XLA keeps it (a bf16 ``F.conv2d`` rounds it to bf16: 3e-3 of
    the largest), the bias's a sequential bf16 sum, bit for bit."""
    rng = np.random.default_rng(k + stride)
    cin, cout = 16, 32
    x = rng.uniform(-1, 1, (4, 32, 32, cin)).astype(np.float32)
    p = {"kernel": (rng.standard_normal((k, k, cin, cout))
                    / np.sqrt(k * k * cin)).astype(np.float32),
         "bias": rng.standard_normal(cout).astype(np.float32)}
    out = -(-32 // stride)
    g = rng.normal(0, 1, (4, out, out, cout)).astype(np.float32)
    conv = fnn.Conv(cout, (k, k), strides=(stride, stride), padding="SAME",
                    dtype=BF)
    gp, gx = _vjp_bf16(lambda p_, v: conv.apply({"params": p_}, v), p, x,
                       jnp.asarray(g).astype(BF))
    ours = _torch_conv(p, cin, cout, k, stride)
    xt = _bf16_torch(x).permute(0, 3, 1, 2).detach().requires_grad_()
    ours(xt).backward(_bf16_torch(g).permute(0, 3, 1, 2))
    dx = xt.grad.float().permute(0, 2, 3, 1).numpy()
    dw = ours.weight.grad.permute(2, 3, 1, 0).numpy()
    print(f"conv {k}x{k}/{stride}: dx {100 * _share(dx, _f32(gx)):.4f} % "
          f"differ; kernel {_rel(dw, gp['kernel']):.2e}")
    assert _share(dx, _f32(gx)) <= 4e-4
    # One rounding step apart (1.5 ulps where it crosses a binade).
    assert _bf16_ulps(dx, _f32(gx)).max() <= 2
    assert _rel(dw, gp["kernel"]) <= 2e-5
    np.testing.assert_array_equal(ours.bias.grad.numpy(), _f32(gp["bias"]))


def _conv_norm_case(c: int = 64):
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (4, 32, 32, c)).astype(np.float32)
    p = {"conv1": {"kernel": (rng.standard_normal((3, 3, c, c)) * 0.05
                              ).astype(np.float32),
                   "bias": (0.1 * rng.standard_normal(c)).astype(np.float32)},
         "gn1": {"scale": (1 + 0.1 * rng.standard_normal(c)).astype(
             np.float32),
                 "bias": (0.1 * rng.standard_normal(c)).astype(np.float32)}}

    class ConvNorm(fnn.Module):
        @fnn.compact
        def __call__(self, v):
            h = fnn.Conv(c, (3, 3), padding="SAME", dtype=BF,
                         name="conv1")(v)
            return fnn.GroupNorm(num_groups=8, dtype=BF, name="gn1")(h)

    conv, gn = _torch_conv(p["conv1"], c, c, 3), tcnn._group_norm(c)
    gn.weight.data = torch.from_numpy(p["gn1"]["scale"])
    gn.bias.data = torch.from_numpy(p["gn1"]["bias"])
    return x, p, ConvNorm(), conv, gn


def test_conv_group_norm_as_the_reference():
    """Flax's GroupNorm after a bf16 conv: f32 statistics of the rounded
    conv, the normalize on the f32 conv + bias (XLA keeps that sum
    unrounded inside its fusion), one rounding. Only the order of the f32
    sums differs: 0.045 % of the values measured one ulp apart."""
    x, p, ref_mod, conv, gn = _conv_norm_case()
    ref = _f32(jax.jit(lambda p_, v: ref_mod.apply({"params": p_}, v))(
        p, jnp.asarray(x).astype(BF)))
    with torch.no_grad():
        got = tcnn.conv_norm(conv, gn, _bf16_torch(x).permute(0, 3, 1, 2))
    got = got.float().permute(0, 2, 3, 1).numpy()
    share = float((got != ref).mean())
    worst = float(np.abs(got - ref).max() / np.abs(ref).max())
    print(f"conv+GroupNorm: {100 * share:.4f} % differ, worst "
          f"{worst:.2e} of the largest value")
    # Measured 0.036 % and 3.2e-3 (about one ulp of a value near the
    # top).
    assert share <= 1e-3 and worst <= 8e-3


def test_conv_group_norm_gradients_as_the_reference():
    """The GroupNorm's two casts of its input to f32 (statistics and
    normalize) each round their share of the input's gradient before the
    two add in bf16; the conv bias's gradient is then a sequential bf16
    sum, bit for bit. Rounding the summed gradient once instead puts 56 %
    of the input's gradient an ulp off; measured now 1.07 %: the order of
    the f32 sums over a group (8192 values here) moves the statistics'
    share by ~1e-5 of itself, which flips its bf16 rounding (0.037 % at
    16 x 16 and 32 channels, 0.22 % at 32 x 32 and 64)."""
    x, p, ref_mod, conv, gn = _conv_norm_case()
    g = np.random.default_rng(8).normal(0, 1, x.shape).astype(np.float32)
    gp, gx = _vjp_bf16(lambda p_, v: ref_mod.apply({"params": p_}, v), p,
                       x, jnp.asarray(g).astype(BF))
    xt = _bf16_torch(x).permute(0, 3, 1, 2).detach().requires_grad_()
    tcnn.conv_norm(conv, gn, xt).backward(
        _bf16_torch(g).permute(0, 3, 1, 2))
    dx = xt.grad.float().permute(0, 2, 3, 1).numpy()
    print(f"conv+GroupNorm gradient: dx {100 * _share(dx, _f32(gx)):.4f} "
          f"% differ")
    assert _share(dx, _f32(gx)) <= 2e-2
    np.testing.assert_array_equal(conv.bias.grad.numpy(),
                                  _f32(gp["conv1"]["bias"]))
    # The kernel's f32 gradient sums the input gradient's flipped
    # roundings: measured 2.9e-4 of its largest.
    assert _rel(conv.weight.grad.permute(2, 3, 1, 0).numpy(),
                gp["conv1"]["kernel"]) <= 1e-3
    # f32 sums over 4096 values in another order: measured 7.7e-5.
    assert _rel(gn.weight.grad.numpy(), gp["gn1"]["scale"]) <= 5e-4
    assert _rel(gn.bias.grad.numpy(), gp["gn1"]["bias"]) <= 5e-4


def test_correlation_and_head_on_the_same_features():
    """On the same bf16 features the corr head is the reference's: the
    correlation's f32 products and sum rounded once, then scaled in bf16;
    the head f32."""
    params, jcfg, sd, cfg = _preset("flagship_fast")
    jb = dataclasses.replace(jcfg, dtype="bfloat16")
    model = _port(sd, dataclasses.replace(cfg, dtype="bfloat16"))
    fw = np.random.default_rng(0).normal(0, 0.5, (2, 5, 16, 16, 256)
                                         ).astype(np.float32)
    fwb = jnp.asarray(fw).astype(BF)
    vols = _f32(jax.jit(lambda a, b: jcnn._correlation_volume(a, b, 3))(
        fwb[:, -1], fwb[:, 0]))
    t = _bf16_torch(fw)
    got = tcnn.correlation_volume(t[:, -1].permute(0, 3, 1, 2),
                                  t[:, :1].permute(0, 1, 4, 2, 3), 3)
    got = got[:, 0].float().permute(0, 2, 3, 1).numpy()
    share = float((got != vols).mean())
    print(f"correlation: {100 * share:.4f} % differ")
    # Measured 0.004 %: the f32 sums' order, as for a conv.
    assert share <= 2e-4 and np.abs(got - vols).max() <= 2 ** -8 * np.abs(
        vols).max()
    ref = np.asarray(jax.jit(lambda p, v: jcnn.offsets_from_feature_windows(
        jb, p, v))(params, fwb))
    with torch.no_grad():
        ours = tcnn.offsets_from_feature_windows(model, t).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


def test_correlation_gradients_as_the_reference():
    """The corr head's gradient into bf16 feature windows: each volume's
    cotangent rounded and scaled, its products rounded, each frame's
    shifts summed in bf16 last to first, the ref's from its concat share
    on (a PyTorch autograd of the forward ops puts 78 % of it off).
    Measured 0.069 % one ulp apart, from the f32 head's sums."""
    params, jcfg, sd, cfg = _preset("flagship_fast")
    jb = dataclasses.replace(jcfg, dtype="bfloat16")
    model = _port(sd, dataclasses.replace(cfg, dtype="bfloat16"))
    rng = np.random.default_rng(0)
    fw = rng.normal(0, 0.5, (2, 5, 16, 16, 256)).astype(np.float32)
    ct = rng.normal(0, 1, (2, 16, 16, 2)).astype(np.float32)
    gp, gv = _vjp_bf16(
        lambda p, v: jcnn.offsets_from_feature_windows(jb, p, v), params, fw,
        jnp.asarray(ct))
    t = _bf16_torch(fw).requires_grad_()
    tcnn.offsets_from_feature_windows(model, t).backward(
        torch.from_numpy(ct))
    share = _share(t.grad.float().numpy(), _f32(gv))
    print(f"correlation gradient: {100 * share:.4f} % differ")
    assert share <= 1e-3
    assert _rel(t.grad.float().numpy(), _f32(gv)) <= 2 ** -8
    grads = tckpt.params_from_flax(_flat(gp), cfg)
    for name, p in model.named_parameters():
        if p.grad is not None:
            assert _rel(p.grad.numpy(), grads[name].numpy()) <= 1e-4, name


# --- the whole model, within a share of the reference's own gap ------------

@pytest.mark.parametrize("name", ["flagship_fast", "flagship"])
def test_full_width_offsets_within_a_share_of_the_gap(name):
    params, jcfg, sd, cfg = _preset(name)
    model = _port(sd, dataclasses.replace(cfg, dtype="bfloat16"))
    err, gap, wit = _offsets_share(jcfg, params, model,
                                   _shaky_windows(cfg, 3, seed=11))
    print(f"{name}: port bf16 {err:.3e} from the reference's bf16; its "
          f"bf16-to-f32 gap {gap:.3e}; share {err / gap:.3f}; witness "
          f"{wit / gap:.3f}")
    assert gap > 1e-5 and err <= GAP_SHARE * gap


def _narrow(arch: str):
    jcfg = JModelConfig(**NARROW, arch=arch)
    params = jcnn.init_params(jcfg, jax.random.key(5))
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(
            np.float32), params)
    cfg = ModelConfig(**NARROW, arch=arch)
    return params, jcfg, tckpt.params_from_flax(_flat(params), cfg), cfg


@pytest.mark.parametrize("arch", ["corr", "stacked"])
def test_narrow_offsets_within_a_share_of_the_gap(arch):
    params, jcfg, sd, cfg = _narrow(arch)
    model = _port(sd, dataclasses.replace(cfg, dtype="bfloat16"))
    err, gap, wit = _offsets_share(jcfg, params, model,
                                   _shaky_windows(cfg, 4, seed=12))
    print(f"{arch}: port bf16 {err:.3e}, gap {gap:.3e}, share "
          f"{err / gap:.3f}, witness {wit / gap:.3f}")
    assert gap > 1e-6 and err <= GAP_SHARE * gap


def test_frames_through_the_lax_stabilizer():
    """The committed fast weights in bf16 through both Stabilizers: the
    share of pixels beyond 1 LSB and the largest miss (measured 0 % and
    1 LSB) held with a margin."""
    params, jcfg, sd, cfg = _preset("flagship_fast")
    frames, _, _ = jsyn.synthetic_clip_u8(jax.random.key(3), 12, 72, 128)
    frames = np.array(frames)
    ref = JStabilizer(JStabilizeConfig(
        model=dataclasses.replace(jcfg, dtype="bfloat16"), chunk_frames=4,
        warp_impl="lax"), params).stabilize_clip(frames)
    ours = tstab.Stabilizer(StabilizeConfig(
        model=dataclasses.replace(cfg, dtype="bfloat16"), chunk_frames=4),
        sd, device="cpu").stabilize_clip(frames)
    diff = np.abs(ours.astype(int) - ref)
    beyond = float((diff > 1).mean())
    print(f"frames: {100 * beyond:.4f} % beyond 1 LSB, max {diff.max()}")
    assert beyond <= 1e-4 and diff.max() <= 2


@functools.lru_cache(maxsize=None)
def _train_case(name: str):
    """One loss step's inputs and the reference's results on them: the
    port renders one batch (batch size 1) and the reference's ``loss_fn``
    (jitted, lax warp) takes the same arrays, in f32 and in bf16. Returns
    (state dict, port ModelConfig, train kwargs, batch, {"f32"/"bf16":
    (loss, gradients by port name)})."""
    if name.startswith("flagship"):
        params, jcfg, sd, cfg = _preset(name)
    else:
        params, jcfg, sd, cfg = _narrow(name)
    tkw = dict(batch_size=1, steps=4, warmup_steps=1, learning_rate=1e-3,
               checkpoint_every=0)
    keys = jax.random.split(jax.random.key(4), 1)
    batch = tloop.render_batch(*_jax_draws(keys, JTrainConfig(
        model=jcfg, **tkw)), TrainConfig(model=cfg, **tkw))
    fixed = tuple(jnp.asarray(a.numpy()) for a in batch)
    sample, impl = jloop._sample_batch, jwarp.resolve_impl
    jloop._sample_batch = lambda *_: fixed
    jwarp.resolve_impl = lambda _: "lax"
    try:
        ref = {}
        for dt in ("f32", "bf16"):
            m = jcfg if dt == "f32" else dataclasses.replace(
                jcfg, dtype="bfloat16")
            step = jax.jit(jax.value_and_grad(jloop.loss_fn, has_aux=True),
                           static_argnums=2)
            (loss, _), grads = step(params, keys,
                                    JTrainConfig(model=m, **tkw))
            ref[dt] = float(loss), tckpt.params_from_flax(_flat(grads), cfg)
    finally:
        jloop._sample_batch, jwarp.resolve_impl = sample, impl
    return sd, cfg, tkw, batch, ref


def _port_step(name: str, dtype: str, onednn: bool = True):
    """The port's (loss, gradients by name) of ``_train_case(name)``."""
    sd, cfg, tkw, batch, _ = _train_case(name)
    tcfg = TrainConfig(model=dataclasses.replace(cfg, dtype=dtype), **tkw)
    model = tcnn.MotionEstimator(tcfg.model)
    model.load_state_dict(sd)
    model.train()
    with torch.backends.mkldnn.flags(enabled=onednn):
        total, _ = tloop.loss_from_batch(model, batch, tcfg)
        total.backward()
    return float(total.detach()), {n: p.grad for n, p in
                                   model.named_parameters()}


def _f32_loss_noise(name: str) -> float:
    """The port's f32 loss against the reference's, over the bf16 gap:
    the two losses' own f32 disagreement, which bounds how close any
    bf16 loss can be held (at full width the gap is of its size)."""
    sd, cfg, tkw, batch, ref = _train_case(name)
    tcfg = TrainConfig(model=cfg, **tkw)
    model = tcnn.MotionEstimator(cfg)
    model.load_state_dict(sd)
    with torch.no_grad():
        total, _ = tloop.loss_from_batch(model, batch, tcfg)
    return abs(float(total) - ref["f32"][0]) / abs(ref["bf16"][0]
                                                  - ref["f32"][0])


def _step_shares(name: str, got, want) -> tuple:
    """(loss share, {tensor: share}) of ``got`` against ``want`` over the
    reference's bf16-to-f32 gap of ``_train_case(name)``."""
    ref = _train_case(name)[4]
    gap = abs(ref["bf16"][0] - ref["f32"][0])
    shares = {n: float((g - want[1][n]).abs().max()
                       / (ref["bf16"][1][n] - ref["f32"][1][n]).abs().max())
              for n, g in got[1].items()}
    return abs(got[0] - want[0]) / gap, shares


@pytest.mark.parametrize("name", ["flagship_fast", "flagship", "corr",
                                  "stacked"])
def test_loss_and_gradients_within_a_share_of_the_gap(name):
    """One bf16 loss step, both presets at full width and both arches
    narrow: the median tensor's largest gradient difference from the
    reference's bf16 step over the reference's own bf16-to-f32
    difference, and, narrow, the loss's (plus the two losses' own f32
    disagreement, ``_f32_loss_noise``). At full width the reference's bf16
    moves its loss by 2e-8 of 9.4e-5 on this batch, and the port's sits
    9.2 of that away (the witness 0.58): that and the worst tensor are
    printed beside the witness (the port with oneDNN off against the
    port), not held (PERF.md §7)."""
    ref = _train_case(name)[4]
    noise = _f32_loss_noise(name)
    ours = _port_step(name, "bfloat16")
    loss, shares = _step_shares(name, ours, ref["bf16"])
    wit_loss, wit = _step_shares(
        name, _port_step(name, "bfloat16", onednn=False), ours)
    worst = max(shares, key=shares.get)
    print(f"{name}: loss {loss:.4f} of the gap (f32 noise {noise:.4f}); "
          f"gradient median "
          f"{np.median(list(shares.values())):.4f}, worst {worst} "
          f"{shares[worst]:.4f}; witness loss {wit_loss:.4f}, median "
          f"{np.median(list(wit.values())):.4f}, worst "
          f"{max(wit.values()):.4f}")
    assert np.median(list(shares.values())) <= GRAD_MEDIAN_SHARE
    if not name.startswith("flagship"):
        assert loss <= LOSS_SHARE + noise


@pytest.mark.parametrize("name", ["corr", "stacked"])
def test_an_f32_step_fails_the_shares(name):
    """The control: the port computing in f32 reads the whole gap (1.0),
    so it fails both limits of the test above."""
    ref = _train_case(name)[4]
    noise = _f32_loss_noise(name)
    loss, shares = _step_shares(name, _port_step(name, "float32"),
                                ref["bf16"])
    print(f"{name} in f32: loss {loss:.4f}, gradient median "
          f"{np.median(list(shares.values())):.4f} of the gap")
    assert loss > LOSS_SHARE + noise
    assert np.median(list(shares.values())) > GRAD_MEDIAN_SHARE


# --- the port against itself ----------------------------------------------

@pytest.mark.parametrize("arch", ["corr", "stacked"])
def test_bf16_is_byte_identical_across_chunk_and_batch(arch):
    """On the CPU a bf16 row's bytes do not depend on its call's size: T =
    4 against 8, and a clip alone against in a batch of two."""
    _, _, sd, cfg = _narrow(arch)
    cfg = StabilizeConfig(model=dataclasses.replace(cfg, dtype="bfloat16"),
                          chunk_frames=4)
    frames, _, _ = jsyn.synthetic_clip_u8(jax.random.key(2), 10, 48, 64)
    clips = np.stack([np.array(frames), np.array(frames)[::-1].copy()])
    stab = tstab.Stabilizer(cfg, sd, device="cpu")
    want = stab.stabilize_clip(clips[0])
    t8 = tstab.Stabilizer(cfg.replace(chunk_frames=8), sd, device="cpu")
    np.testing.assert_array_equal(t8.stabilize_clip(clips[0]), want)
    got = tstab.drive_chunked_batch(
        tstab.ChunkStep(cfg, stab.model, batched=True), clips)
    np.testing.assert_array_equal(got[0], want)


@pytest.mark.parametrize("arch", ["corr", "stacked"])
def test_bf16_artifact_equals_the_live_path(tmp_path, arch):
    _, _, sd, cfg = _narrow(arch)
    cfg = StabilizeConfig(model=dataclasses.replace(cfg, dtype="bfloat16"),
                          chunk_frames=4, path_smooth=8)
    frames, _, _ = jsyn.synthetic_clip_u8(jax.random.key(6), 6, 48, 64)
    frames = np.array(frames)
    exp = texport.export_chunk_program(cfg, sd, 48, 64, device="cpu")
    path = str(tmp_path / "bf16.dvsgt")
    texport.save_exported(exp, path, cfg)
    loaded = texport.load_exported(path)
    assert loaded.cfg == cfg          # the header's dtype and arch
    want = tstab.Stabilizer(cfg, sd, device="cpu").stabilize_clip(frames)
    np.testing.assert_array_equal(loaded.stabilize_clip(frames), want)
