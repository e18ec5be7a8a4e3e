"""The port's tensor parallelism (parallel/mesh.py ``tp_param_sharding``,
parallel/tp.py) on the CPU: the spec shards the leaves the JAX package's
spec shards, a mesh without a ``model`` axis is refused, and in spawned
gloo ranks on ("data", "model") meshes of (1, 2), (2, 2) and (1, 4) (the
head's 2-channel output replicated there) the sharded
model's offsets are within 2e-5 of the unsharded model's (the reference's
tolerance, tests/test_parallel.py) and a clip through the TP chunk step is
within 1 LSB of ``stabilize_clip``.
"""

import os

import jax
import numpy as np
import pytest
import torch

import torch_ranks
from dvsg_tpu.parallel import mesh as jmesh
from dvsg_tpu.utils import checkpoint as jckpt
from dvsg_tpu_torch.config import StabilizeConfig
from dvsg_tpu_torch.models import motion_cnn
from dvsg_tpu_torch.parallel import dryrun, tp
from dvsg_tpu_torch.parallel import mesh as mesh_lib
from dvsg_tpu_torch.pipeline.stabilize import Stabilizer, build_model
from dvsg_tpu_torch.train import synthetic
from dvsg_tpu_torch.utils import checkpoint as ckpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MCFG, PARAMS = dryrun.tiny_setup()
CFG = StabilizeConfig(model=MCFG, chunk_frames=4)
SHAPES = ((1, 2), (2, 2), (1, 4))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clip(n, key, h=32, w=40):
    return synthetic.synthetic_clip_u8(torch.Generator().manual_seed(key),
                                       n, h, w)[0].numpy()


def _lsb(a, b):
    return int(np.abs(a.astype(int) - b.astype(int)).max())


@pytest.fixture(scope="module")
def payload():
    rng = np.random.default_rng(0)
    mh, mw = MCFG.model_size
    windows = (rng.random((8, mh, mw, 3 * MCFG.window), np.float32)
               - 0.5).astype(np.float32)
    return {"cfg": CFG, "params": PARAMS, "shapes": SHAPES,
            "windows": windows, "clip": _clip(6, key=7),
            "clips": np.stack([_clip(5, key=k) for k in (8, 9)])}


@pytest.fixture(scope="module")
def ranks(payload, tmp_path_factory):
    """One spawn of four gloo ranks serving every mesh shape."""
    return torch_ranks.spawn("tp", 4, tmp_path_factory.mktemp("tp"),
                             payload)


@pytest.mark.parametrize("m", [2, 4])
def test_spec_shards_the_reference_leaves(m):
    """On the committed fast checkpoint, the same leaves shard over a model
    axis of m as in the reference's spec over a (8/m, m) mesh."""
    npz = os.path.join(ROOT, "checkpoints", "flagship_fast.npz")
    jparams, _ = jckpt.load_npz(npz)
    jspec = jmesh.tp_param_sharding(
        jmesh.make_mesh((8 // m, m), axis_names=("data", "model")), jparams)
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        jspec, is_leaf=lambda x: hasattr(x, "spec"))
    want = {"/".join(str(getattr(k, "key", k)) for k in path)
            for path, s in leaves if jmesh.MODEL_AXIS in str(s.spec)}
    params, _ = ckpt.load_npz(npz)
    spec = mesh_lib.tp_param_sharding(
        mesh_lib.Mesh((1, m), ("data", "model"), 0, torch.device("cpu")),
        params)
    names = ckpt.params_to_flax({k: params[k] for k, s in spec.items()
                                 if s})
    assert want and set(names) == want
    assert all(s in ((), ("model", None, None, None)) for s in spec.values())
    assert any(s == () for s in spec.values())


def test_spec_requires_a_model_axis():
    m = mesh_lib.make_mesh(device="cpu")            # a data-only mesh
    with pytest.raises(ValueError, match="no 'model' axis"):
        mesh_lib.tp_param_sharding(m, PARAMS)
    with pytest.raises(ValueError, match="no 'model' axis"):
        tp.tp_model(build_model(MCFG, PARAMS, torch.device("cpu")), m)


def test_one_process_mesh_is_the_plain_stabilizer():
    """A (1, 1) mesh in one process: the TP stabilizer's bytes are the
    plain stabilizer's."""
    m = mesh_lib.make_mesh((1, 1), axis_names=("data", "model"),
                           device="cpu")
    assert m.along("model").size == m.along("data").size == 1
    clip = _clip(6, key=7)
    want = Stabilizer(CFG, PARAMS, device="cpu").stabilize_clip(clip)
    np.testing.assert_array_equal(
        tp.TPStabilizer(CFG, PARAMS, m).stabilize_clip(clip), want)


@pytest.mark.parametrize("shape", SHAPES, ids=["1x2", "2x2", "1x4"])
def test_tp_offsets_match_unsharded(ranks, payload, shape):
    key = "x".join(map(str, shape))
    got = [r[key] for r in ranks if key in r]
    assert len(got) == shape[0] * shape[1]
    assert {g["coords"] for g in got} == {(d, m) for d in range(shape[0])
                                          for m in range(shape[1])}
    model = build_model(MCFG, PARAMS, torch.device("cpu"))
    with torch.inference_mode():
        want = motion_cnn.predict_offsets(
            model, torch.from_numpy(payload["windows"])).numpy()
    assert np.abs(want).max() > 1e-3                 # the head moves pixels
    for g in got:
        assert any(s for s in g["spec"].values())
        np.testing.assert_allclose(g["offsets"], want[g["rows"]], atol=2e-5)


@pytest.mark.parametrize("shape", SHAPES, ids=["1x2", "2x2", "1x4"])
def test_tp_clip_within_one_lsb(ranks, payload, shape):
    """A clip through the TP chunk step on every rank, and a clip batch
    over the data axis, within 1 LSB of ``stabilize_clip``."""
    key = "x".join(map(str, shape))
    stab = Stabilizer(CFG, PARAMS, device="cpu")
    want = stab.stabilize_clip(payload["clip"])
    wants = [stab.stabilize_clip(c) for c in payload["clips"]]
    for g in (r[key] for r in ranks if key in r):
        assert g["clip"].shape == want.shape
        assert _lsb(g["clip"], want) <= 1
        assert len(g["clips"]) == len(wants)
        for a, b in zip(g["clips"], wants):
            assert _lsb(a, b) <= 1
