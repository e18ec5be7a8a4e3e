"""Checkpoint export of the port: the inverse parameter mapping, and files
the JAX package reads back."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dvsg_tpu.models import motion_cnn as jcnn
from dvsg_tpu.utils import checkpoint as jckpt
from dvsg_tpu_torch.config import ModelConfig, config_to_json
from dvsg_tpu_torch.models import motion_cnn as tcnn
from dvsg_tpu_torch.utils import checkpoint as tckpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPTS = ["flagship_fast.npz", "flagship.npz"]


def _raw(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("name", CKPTS)
def test_params_to_flax_inverts_params_from_flax_bytewise(name):
    raw = _raw(os.path.join(ROOT, "checkpoints", name))
    cfg_bytes = raw.pop("__config__")
    _, cfg = tckpt.load_npz(os.path.join(ROOT, "checkpoints", name))
    back = tckpt.params_to_flax(tckpt.params_from_flax(raw, cfg))
    assert set(back) == set(raw)
    for k, v in raw.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
        assert back[k].tobytes() == np.ascontiguousarray(v).tobytes(), k
    # the config record is the reference's own JSON
    assert config_to_json(cfg).encode() == cfg_bytes.tobytes()


@pytest.mark.parametrize("name", CKPTS)
def test_exported_npz_roundtrips_the_committed_file(name, tmp_path):
    src = os.path.join(ROOT, "checkpoints", name)
    params, cfg = tckpt.load_npz(src)
    out = str(tmp_path / "exported.npz")
    tckpt.export_npz(out, params, cfg)
    assert os.path.exists(out)                      # no suffix appended
    a, b = _raw(src), _raw(out)
    assert set(a) == set(b)
    for k in a:
        assert a[k].tobytes() == b[k].tobytes(), k
    # and the reference reads it into the same tree as the committed file
    want, jcfg = jckpt.load_npz(src)
    got, jcfg2 = jckpt.load_npz(out)
    assert jcfg == jcfg2
    jax.tree_util.tree_map(
        lambda x, y: np.testing.assert_array_equal(np.asarray(x),
                                                   np.asarray(y)),
        want, got)


def test_reference_loads_port_trained_weights_same_offsets(tmp_path):
    """A port-initialized (and perturbed) model exported to .npz predicts
    the same offsets through the reference's model."""
    cfg = ModelConfig(window=3, model_size=(32, 32), grid_size=(8, 8),
                      base_features=8, blocks_per_level=1, max_offset=0.15)
    g = torch.Generator().manual_seed(0)
    params = tcnn.init_params(cfg, g)
    params["head_out.weight"] = 0.05 * torch.randn(
        params["head_out.weight"].shape, generator=g)
    out = str(tmp_path / "port.npz")
    tckpt.export_npz(out, params, cfg)
    jparams, jcfg = jckpt.load_npz(out)
    assert tuple(jcfg.model_size) == (32, 32) and jcfg.window == 3

    rng = np.random.default_rng(1)
    frames = (rng.random((2, 3, 32, 32, 3), dtype=np.float32) - 0.5)
    model = tcnn.MotionEstimator(cfg)
    model.load_state_dict(params)
    model.eval()
    with torch.no_grad():
        feats = tcnn.encode_frames(model,
                                   torch.from_numpy(frames).flatten(0, 1))
        ours = tcnn.offsets_from_feature_windows(
            model, feats.reshape(2, 3, *feats.shape[1:])).numpy()
    jfeats = jcnn.encode_frames(jcfg, jparams,
                                jnp.asarray(frames.reshape(6, 32, 32, 3)))
    want = jcnn.offsets_from_feature_windows(
        jcfg, jparams, jfeats.reshape((2, 3) + jfeats.shape[1:]))
    assert np.abs(ours).max() > 1e-3
    np.testing.assert_allclose(ours, np.asarray(want), rtol=0, atol=1e-5)


def test_checkpoint_dir_params_load_in_the_reference(tmp_path):
    """The params file of a training checkpoint directory is the same
    single-file format."""
    cfg = ModelConfig(window=3, model_size=(32, 32), grid_size=(8, 8),
                      base_features=8, blocks_per_level=1)
    params = tcnn.init_params(cfg, torch.Generator().manual_seed(2))
    d = str(tmp_path / "ckpt")
    tckpt.save_checkpoint(d, params, cfg, step=4)
    jparams, jcfg = jckpt.load_npz(os.path.join(d, "params", "4.npz"))
    assert jcfg.grid_size == (8, 8)
    np.testing.assert_array_equal(
        np.asarray(jparams["encoder"]["stem"]["kernel"]),
        params["encoder.stem.weight"].permute(2, 3, 1, 0).numpy())


def test_params_to_flax_rejects_unknown_leaf():
    with pytest.raises(KeyError):
        tckpt.params_to_flax({"encoder.stem.running_mean": torch.zeros(3)})
