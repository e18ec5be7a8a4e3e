"""The port's temporal sharding (parallel/temporal.py) on the CPU, in
spawned gloo ranks: the frame axis of every chunk over 2 and 4 ranks, with
the halo passed round the ring and, with path smoothing, the per-pair
deltas gathered.

Every clip is byte-identical to the port's single process at the same
chunk size, on every rank, and within 1 LSB of the JAX package's
``TemporalShardedStabilizer`` on a virtual mesh of as many devices
(mirrors of tests/test_temporal.py).
"""

import numpy as np
import pytest
import torch

import torch_ranks
from dvsg_tpu.config import ModelConfig as JModelConfig
from dvsg_tpu.config import StabilizeConfig as JStabilizeConfig
from dvsg_tpu.parallel import mesh as jmesh
from dvsg_tpu.parallel.temporal import TemporalShardedStabilizer as JTemporal
from dvsg_tpu.utils import checkpoint as jckpt
from dvsg_tpu_torch.config import StabilizeConfig
from dvsg_tpu_torch.parallel import dryrun
from dvsg_tpu_torch.parallel import mesh as mesh_lib
from dvsg_tpu_torch.parallel.temporal import TemporalShardedStabilizer
from dvsg_tpu_torch.pipeline.stabilize import Stabilizer
from dvsg_tpu_torch.train import synthetic
from dvsg_tpu_torch.utils import checkpoint as ckpt

MCFG, PARAMS = dryrun.tiny_setup()
CFG = StabilizeConfig(model=MCFG, chunk_frames=4)
JMCFG = JModelConfig(window=3, model_size=(32, 32), grid_size=(8, 8),
                     base_features=8, blocks_per_level=1)
FRAMES = 19                 # a partial last chunk at 4 and at 8 frames
RANKS = ("2", "4")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def clip():
    return synthetic.synthetic_clip_u8(torch.Generator().manual_seed(7),
                                       FRAMES, 32, 40)[0].numpy()


@pytest.fixture(scope="module")
def ranks(clip, tmp_path_factory):
    """One spawn of four gloo ranks serving every case (a 4-rank mesh and
    a mesh of ranks 0 and 1)."""
    return torch_ranks.spawn("temporal", 4, tmp_path_factory.mktemp("ranks"),
                             dict(cfg=CFG, params=PARAMS, clip=clip))


def _single(cfg, clip):
    return Stabilizer(cfg, PARAMS, device="cpu").stabilize_clip(clip)


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("mode", ["plain", "causal"])
def test_matches_one_process(ranks, clip, n, mode):
    cfg = CFG.replace(chunk_frames=2 * int(n),
                      **torch_ranks.MODES[mode])
    want = _single(cfg, clip)
    got = [r[f"{n}/{mode}"] for r in ranks if f"{n}/{mode}" in r]
    assert len(got) == int(n)           # every rank gets the whole clip
    for g in got:
        np.testing.assert_array_equal(g, want)


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("mode", ["plain", "causal"])
def test_matches_reference_temporal(ranks, clip, n, mode, tmp_path):
    path = str(tmp_path / "tiny.npz")
    ckpt.export_npz(path, PARAMS, MCFG)
    jcfg = JStabilizeConfig(model=JMCFG, chunk_frames=2 * int(n),
                            warp_impl="lax", **torch_ranks.MODES[mode])
    want = JTemporal(jcfg, jckpt.load_npz(path)[0],
                     jmesh.make_mesh((int(n),))).stabilize_clip(clip)
    got = ranks[0][f"{n}/{mode}"]
    assert int(np.abs(got.astype(int) - np.asarray(want).astype(int)
                      ).max()) <= 1


@pytest.mark.parametrize("n", RANKS)
def test_strength_zero_is_a_passthrough(ranks, clip, n):
    for r in ranks:
        if f"{n}/strength0" in r:
            np.testing.assert_array_equal(r[f"{n}/strength0"], clip)


@pytest.mark.parametrize("case,match", [
    ("lag", "path_smooth_lag is not supported on the temporal-sharded "
            "surface"),
    ("indivisible", "must divide over"),
    ("short", r"shorter than the model's halo \(window-1 = 2\)"),
])
@pytest.mark.parametrize("n", RANKS)
def test_refusals(ranks, case, match, n):
    import re
    assert re.search(match, ranks[0][f"{n}/{case}"])


def test_one_process_mesh_matches_stabilizer(clip):
    """A mesh of one process (no process group): the ring hands the rank
    its own tail, the next chunk's halo."""
    m = mesh_lib.make_mesh(device="cpu")
    for mode in ("plain", "causal"):
        cfg = CFG.replace(**torch_ranks.MODES[mode])
        np.testing.assert_array_equal(
            TemporalShardedStabilizer(cfg, PARAMS, m).stabilize_clip(clip),
            _single(cfg, clip))
