"""The port's motion CNN against the JAX package, on both shipped checkpoints.

Weights cross through ``params_from_flax`` from the flax tree itself
(``jax.tree_util.tree_flatten_with_path``). Encoder features and offsets
hold atol 1e-4 (f32 convolutions summed in another order).
"""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dvsg_tpu.models import motion_cnn as jmodel
from dvsg_tpu.utils import checkpoint as jckpt
from dvsg_tpu_torch.config import ModelConfig
from dvsg_tpu_torch.models import motion_cnn as tmodel
from dvsg_tpu_torch.ops import grid as grid_ops
from dvsg_tpu_torch.utils import checkpoint as tckpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPTS = {"flagship": 80, "flagship_fast": 38}


def _flat(params) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(leaf) for path, leaf in leaves}


@pytest.fixture(scope="module", params=sorted(CKPTS))
def pair(request):
    name = request.param
    params, jcfg = jckpt.load_npz(os.path.join(ROOT, "checkpoints",
                                               name + ".npz"))
    cfg = ModelConfig(**{k: getattr(jcfg, k) for k in
                         ModelConfig.__dataclass_fields__})
    model = tmodel.MotionEstimator(cfg)
    model.load_state_dict(tckpt.params_from_flax(_flat(params), cfg))
    return name, jcfg, params, model.eval()


def test_params_from_flax_maps_every_array(pair):
    name, _, params, model = pair
    flat = _flat(params)
    assert len(flat) == CKPTS[name]
    sd = tckpt.params_from_flax(flat, model.cfg)
    assert len(sd) == CKPTS[name] == len(model.state_dict())
    for path, arr in flat.items():
        key = path.replace("/", ".").replace(".kernel", ".weight").replace(
            ".scale", ".weight")
        want = (arr.transpose(3, 2, 0, 1) if path.endswith("kernel")
                else arr)
        np.testing.assert_array_equal(sd[key].numpy(), want)


def test_load_npz_equals_params_from_flax(pair):
    name, _, params, model = pair
    sd, cfg = tckpt.load_npz(os.path.join(ROOT, "checkpoints",
                                          name + ".npz"))
    assert cfg == model.cfg
    for k, v in model.state_dict().items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0)


def test_encode_frames_matches_reference(pair):
    _, jcfg, params, model = pair
    mh, mw = jcfg.model_size
    x = np.random.default_rng(0).uniform(
        -0.5, 0.5, (2, mh, mw, 3)).astype(np.float32)
    ref = np.asarray(jmodel.encode_frames(jcfg, params, jnp.asarray(x)))
    with torch.no_grad():
        ours = tmodel.encode_frames(model, torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape == (2, 16, 16, 256)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)


def test_offsets_from_feature_windows_matches_reference(pair):
    _, jcfg, params, model = pair
    fw = np.random.default_rng(1).standard_normal(
        (3, jcfg.window, 16, 16, 256)).astype(np.float32)
    ref = np.asarray(jmodel.offsets_from_feature_windows(
        jcfg, params, jnp.asarray(fw)))
    with torch.no_grad():
        ours = tmodel.offsets_from_feature_windows(
            model, torch.from_numpy(fw)).numpy()
    assert ours.shape == ref.shape == (3, 16, 16, 2)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)
    assert np.abs(ours).max() <= jcfg.max_offset


def test_same_padding_of_stride2_conv_is_0_1():
    """Flax SAME on a stride-2 3x3 conv over an even input pads (0, 1):
    torch's symmetric padding=1 would shift every output by half a pixel."""
    assert tmodel.same_pads(256, 3, 2) == (0, 1)
    assert tmodel.same_pads(255, 3, 2) == (1, 1)
    assert tmodel.same_pads(64, 7, 1) == (3, 3)
    rng = np.random.default_rng(2)
    for size in (16, 15):
        x = rng.standard_normal((1, size, size, 4)).astype(np.float32)
        conv = fnn.Conv(5, (3, 3), strides=(2, 2), padding="SAME")
        p = conv.init(jax.random.key(0), jnp.asarray(x))
        ref = np.asarray(conv.apply(p, jnp.asarray(x)))
        tconv = tmodel.SameConv2d(4, 5, 3, stride=2)
        with torch.no_grad():
            tconv.weight.copy_(torch.from_numpy(np.array(
                p["params"]["kernel"]).transpose(3, 2, 0, 1)))
            tconv.bias.copy_(torch.from_numpy(np.array(
                p["params"]["bias"])))
            ours = tconv(torch.from_numpy(x).permute(0, 3, 1, 2))
            sym = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                           tconv.weight, tconv.bias, stride=2, padding=1)
        ours = ours.permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
        if size % 2 == 0:
            assert np.abs(sym.permute(0, 2, 3, 1).numpy() - ref).max() > 1e-2


def test_gelu_is_tanh_approximation():
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    ref = np.asarray(fnn.gelu(jnp.asarray(x)))
    ours = tmodel.gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)
    exact = F.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(exact - ref).max() > 1e-4


def test_group_norm_matches_flax_epsilon():
    x = (np.random.default_rng(3).standard_normal((2, 4, 4, 16))
         * 1e-3).astype(np.float32)          # small variance: eps matters
    gn = fnn.GroupNorm(num_groups=8)
    p = gn.init(jax.random.key(0), jnp.asarray(x))
    ref = np.asarray(gn.apply(p, jnp.asarray(x)))
    tgn = tmodel._group_norm(16)
    with torch.no_grad():
        ours = tgn(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(), ref,
                               rtol=0, atol=1e-4)
    assert tgn.eps == 1e-6 and tgn.num_groups == 8


def test_correlation_volume_matches_reference():
    rng = np.random.default_rng(4)
    ref_f = rng.standard_normal((2, 6, 7, 16)).astype(np.float32)
    other = rng.standard_normal((2, 6, 7, 16)).astype(np.float32)
    want = np.asarray(jmodel._correlation_volume(
        jnp.asarray(ref_f), jnp.asarray(other), 2))
    got = tmodel.correlation_volume(
        torch.from_numpy(ref_f).permute(0, 3, 1, 2),
        torch.from_numpy(other).permute(0, 3, 1, 2)[:, None], 2)
    got = got[:, 0].permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_params_from_flax_rejects_bad_trees(pair):
    _, _, params, model = pair
    flat = _flat(params)
    missing = dict(flat)
    missing.pop("head_out/bias")
    with pytest.raises(KeyError, match="missing"):
        tckpt.params_from_flax(missing, model.cfg)
    extra = dict(flat)
    extra["encoder/res9_9/conv1/kernel"] = flat["head_out/kernel"]
    with pytest.raises(KeyError):
        tckpt.params_from_flax(extra, model.cfg)
    bad = dict(flat)
    bad["head_out/bias"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.params_from_flax(bad, model.cfg)


@pytest.mark.parametrize("kw", [dict(arch="stacked"),
                                dict(dtype="bfloat16")])
def test_model_variants_build_and_start_at_identity(kw):
    """Both of the reference's other variants build (they were refused
    before they were ported); a fresh init predicts zero offsets, and only
    the corr arch caches features."""
    cfg = ModelConfig(window=3, model_size=(32, 32), grid_size=(8, 8),
                      base_features=8, blocks_per_level=1, **kw)
    model = tmodel.MotionEstimator(cfg)
    model.load_state_dict(tmodel.init_params(cfg, torch.Generator()
                                             .manual_seed(0)))
    windows = torch.rand(2, 32, 32, 9, generator=torch.Generator()
                         .manual_seed(1)) - 0.5
    with torch.no_grad():
        off = tmodel.predict_offsets(model, windows)
    assert off.shape == (2, 8, 8, 2) and off.dtype == torch.float32
    assert not off.any()
    if cfg.arch == "stacked":
        with pytest.raises(ValueError, match="corr architecture"):
            tmodel.encode_frames(model, windows[..., :3])


GRID_HW = ((48, 56), (130, 200))


@pytest.fixture(scope="module")
def ref_grids(pair):
    """The reference's predict_grid at both output resolutions on seeded
    windows, in one jitted call (its model runs once)."""
    _, jcfg, params, _ = pair
    mh, mw = jcfg.model_size
    w = np.random.default_rng(5).uniform(
        -0.5, 0.5, (2, mh, mw, jcfg.window * 3)).astype(np.float32)
    grids = jax.jit(lambda p, x: [jmodel.predict_grid(jcfg, p, x, *hw)
                                  for hw in GRID_HW])(params, jnp.asarray(w))
    return w, dict(zip(GRID_HW, map(np.asarray, grids)))


@pytest.mark.parametrize("out_hw", GRID_HW)
def test_predict_grid_matches_reference(pair, ref_grids, out_hw):
    """Dense grids from the same windows and weights: within the offsets'
    atol 1e-4 (the grid is the identity plus the upsampled offsets), at
    two output resolutions, against ``grid_from_offsets(predict_offsets)``
    bit for bit."""
    model = pair[3]
    w, want = ref_grids
    ref = want[out_hw]
    x = torch.from_numpy(w)
    with torch.no_grad():
        ours = tmodel.predict_grid(model, x, *out_hw)
        composed = grid_ops.grid_from_offsets(
            tmodel.predict_offsets(model, x), *out_hw)
    assert ours.shape == ref.shape == (2, *out_hw, 2)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-4)
    torch.testing.assert_close(ours, composed, rtol=0, atol=0)


# A small model whose head moves pixels: a seeded init with numpy noise on
# every leaf (as tests/test_torch_train.py perturbs it), so the zero
# head_out kernel does not silence the gradients before it.
GRAD_KW = dict(window=3, model_size=(32, 32), grid_size=(8, 8),
               base_features=8, blocks_per_level=1, max_offset=0.15)


def test_predict_grid_gradients_match_jax_grad():
    """Every parameter's gradient of sum(grid**2) through autograd against
    jax.grad through the reference's predict_grid: the max-abs error over
    each tensor's largest gradient below 1e-4, the training tests'
    tolerance."""
    from dvsg_tpu.config import ModelConfig as JModelConfig
    jcfg, cfg = JModelConfig(**GRAD_KW), ModelConfig(**GRAD_KW)
    rng = np.random.default_rng(6)
    flat = {k: v + 0.05 * rng.standard_normal(v.shape).astype(np.float32)
            for k, v in tckpt.params_to_flax(tmodel.init_params(
                cfg, torch.Generator().manual_seed(6))).items()}
    params = {}
    for path, v in flat.items():
        *mods, leaf = path.split("/")
        node = params
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = jnp.asarray(v)
    w = rng.uniform(-0.5, 0.5, (2, 32, 32, 9)).astype(np.float32)
    want = jax.jit(jax.grad(lambda p: jnp.sum(jmodel.predict_grid(
        jcfg, p, jnp.asarray(w), 40, 48) ** 2)))(params)
    want = tckpt.params_from_flax(_flat(want), cfg)

    model = tmodel.MotionEstimator(cfg)
    model.load_state_dict(tckpt.params_from_flax(flat, cfg))
    tmodel.predict_grid(model, torch.from_numpy(w), 40, 48).pow(2).sum(
        ).backward()
    named = dict(model.named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        scale = float(want[name].abs().max())
        assert scale > 0, name
        err = float((p.grad - want[name]).abs().max()) / scale
        assert err < 1e-4, (name, err)
