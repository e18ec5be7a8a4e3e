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
def test_unported_model_variants_raise(kw):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tmodel.MotionEstimator(ModelConfig(**kw))
