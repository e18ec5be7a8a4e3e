"""The port's data-parallel surfaces on the CPU (parallel/mesh.py,
parallel/dp.py, ``stabilize_multi(mesh=)``, ``stabilize-batch`` under
several ranks, parallel/dryrun.py), in spawned gloo ranks.

Every sharded output is byte-identical to the port's single process on
the same clips, on every rank, and within 1 LSB of the JAX package's
``ShardedClipStabilizer`` on the conftest's 8-device virtual mesh; the
data-parallel train step is within the reference's own tolerances (loss
rtol 1e-5, parameters atol 1e-6, tests/test_parallel.py) of the port's
single-process step and of the JAX package's ``make_dp_train_step``.
"""


import jax
import numpy as np
import pytest
import torch

import torch_ranks
from dvsg_tpu.config import ModelConfig as JModelConfig
from dvsg_tpu.config import StabilizeConfig as JStabilizeConfig
from dvsg_tpu.config import TrainConfig as JTrainConfig
from dvsg_tpu.models import motion_cnn as jcnn
from dvsg_tpu.parallel import dp as jdp
from dvsg_tpu.parallel import mesh as jmesh
from dvsg_tpu.train import loop as jloop
from dvsg_tpu.train import synthetic as jsyn
from dvsg_tpu.utils import checkpoint as jckpt
from dvsg_tpu_torch import cli
from dvsg_tpu_torch.config import ModelConfig, StabilizeConfig, TrainConfig
from dvsg_tpu_torch.parallel import dp, dryrun
from dvsg_tpu_torch.parallel import mesh as mesh_lib
from dvsg_tpu_torch.pipeline import multiclip
from dvsg_tpu_torch.pipeline.stabilize import Stabilizer
from dvsg_tpu_torch.train import loop, synthetic
from dvsg_tpu_torch.utils import checkpoint as ckpt
from dvsg_tpu_torch.utils import video_io

MKW = dict(window=3, model_size=(32, 32), grid_size=(8, 8),
           base_features=8, blocks_per_level=1)
MCFG, JMCFG = ModelConfig(**MKW), JModelConfig(**MKW)
CFG = StabilizeConfig(model=MCFG, chunk_frames=4)
JCFG = JStabilizeConfig(model=JMCFG, chunk_frames=4, warp_impl="lax")
TKW = dict(batch_size=8, steps=20, warmup_steps=2, learning_rate=1e-3,
           checkpoint_every=0)
TCFG, JTCFG = TrainConfig(model=MCFG, **TKW), JTrainConfig(model=JMCFG,
                                                           **TKW)
MODES = torch_ranks.MODES


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


def _flat(params):
    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.array(v)
            for path, v in leaves}


def _jax_draws(keys, cfg):
    """The draws the reference's _sample_batch makes from ``keys``
    (fold_in 0 / 1 / 2): stills, paths, gains, as torch tensors."""
    clip_len = cfg.model.window + jloop._STEPS_PER_CLIP - 1
    fold = lambda i: jax.vmap(lambda k: jax.random.fold_in(k, i))(keys)
    stills = jloop._draw_stills(fold(0), cfg, None)
    paths = jax.vmap(
        lambda k: jsyn.random_camera_path(k, clip_len))(fold(1))
    gains = 1.0 + 0.03 * jax.vmap(lambda k: jax.random.uniform(
        k, (clip_len,), minval=-1.0, maxval=1.0))(fold(2))
    return tuple(torch.from_numpy(np.array(a))
                 for a in (stills, paths, gains))


@pytest.fixture(scope="module")
def params():
    """The tiny model with a head that moves pixels."""
    mcfg, p = dryrun.tiny_setup()
    assert mcfg == MCFG
    return p


@pytest.fixture(scope="module")
def jparams(params, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("w") / "tiny.npz")
    ckpt.export_npz(path, params, MCFG)
    return jckpt.load_npz(path)[0]


@pytest.fixture(scope="module")
def clips():
    return np.stack([_clip(6, key=k) for k in range(8)])


@pytest.fixture(scope="module")
def train_setup():
    """Perturbed flax weights (so every gradient is alive), the same in
    the port's layout, and the JAX draws of two steps."""
    jp = jcnn.init_params(JMCFG, jax.random.key(5))
    rng = np.random.default_rng(5)
    jp = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(
            np.float32), jp)
    keys = [jax.random.key(42), jax.random.key(43)]
    draws = [_jax_draws(jloop.batch_keys(k, JTCFG), JTCFG) for k in keys]
    return jp, ckpt.params_from_flax(_flat(jp), MCFG), keys, draws


@pytest.fixture(scope="module")
def sharded(params, clips, train_setup, tmp_path_factory):
    """One spawn of four gloo ranks serving every sharded case."""
    _, tparams, _, draws = train_setup
    return torch_ranks.spawn(
        "sharded", 4, tmp_path_factory.mktemp("ranks"),
        dict(cfg=CFG, params=params, clips=clips, tcfg=TCFG,
             tparams=tparams, draws=draws))


def test_mesh_shape_cross_loads_both_ways():
    """The config field the JAX package declares for its mesh: a port
    record loads in the JAX package and back; a JAX record still names
    warp_impl, which the port refuses."""
    import dataclasses
    import json
    from dvsg_tpu.config import config_to_json as jconfig_to_json
    from dvsg_tpu.config import stabilize_config_from_dict as jfrom_dict
    from dvsg_tpu_torch.config import config_to_json, \
        stabilize_config_from_dict
    cfg = CFG.replace(mesh_shape=(4,))
    jcfg = jfrom_dict(json.loads(config_to_json(cfg)))
    assert jcfg.mesh_shape == (4,) and jcfg.chunk_frames == 4
    d = json.loads(jconfig_to_json(jcfg))
    assert d.pop("warp_impl") == "auto"
    assert stabilize_config_from_dict(d) == cfg
    with pytest.raises(TypeError, match="warp_impl"):
        stabilize_config_from_dict(json.loads(jconfig_to_json(jcfg)))
    assert dataclasses.asdict(StabilizeConfig())["mesh_shape"] == (1,)


def test_make_mesh_in_one_process():
    m = mesh_lib.make_mesh(device="cpu")
    assert (m.shape, m.axis_names, m.rank, m.size, m.group, m.device.type) \
        == ((1,), ("data",), 0, 1, None, "cpu")
    assert m.shard(3) == slice(0, 3)
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        mesh_lib.make_mesh((2,), device="cpu")


def test_mesh_shapes_over_four_ranks(sharded):
    for r, res in enumerate(sharded):
        assert res["mesh"]["4"] == ((4,), r, "gloo", "cpu")
        assert res["mesh"]["2"] == ((2,), r if r < 2 else None,
                                    "gloo" if r < 2 else None, "cpu")


def test_init_distributed_single_process_noop(monkeypatch):
    for k in ("MASTER_ADDR", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert mesh_lib.init_distributed(device="cpu") is None


def test_init_distributed_arg_plumbing(monkeypatch):
    seen = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: seen.append((backend, kw)))
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)
    assert mesh_lib.init_distributed("10.0.0.1:1234", num_processes=4,
                                     process_id=1, device="cpu") == "gloo"
    backend, kw = seen[-1]
    assert (backend, kw["init_method"], kw["world_size"], kw["rank"]) == \
        ("gloo", "tcp://10.0.0.1:1234", 4, 1)
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert mesh_lib.init_distributed(device="cpu") == "gloo"
    assert seen[-1][1]["init_method"] == "env://"
    # A card asked for and absent: an error, never a quiet gloo group.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh_lib.init_distributed("10.0.0.1:1234", 2, 0, device="cuda")


@pytest.mark.parametrize("mode", list(MODES))
def test_sharded_clips_match_one_process(sharded, params, clips, mode):
    cfg = CFG.replace(**MODES[mode])
    single = Stabilizer(cfg, params, device="cpu")
    want = np.stack([single.stabilize_clip(c) for c in clips])
    for r, res in enumerate(sharded):
        for n in ("2", "4"):
            if f"{n}/{mode}" in res:
                np.testing.assert_array_equal(res[f"{n}/{mode}"], want,
                                              err_msg=f"rank {r}, {n} ranks")
    assert sum(f"2/{mode}" in res for res in sharded) == 2


@pytest.mark.parametrize("mode", list(MODES))
def test_sharded_clips_match_reference_mesh(sharded, jparams, clips, mode):
    jcfg = JCFG.replace(**MODES[mode])
    want = jdp.ShardedClipStabilizer(jcfg, jparams, jmesh.make_mesh()
                                     ).stabilize_clips(clips)
    assert _lsb(sharded[0][f"4/{mode}"], np.asarray(want)) <= 1


def test_sharded_refusals(sharded):
    assert "clip batch 6 must divide evenly over 4 devices" \
        in sharded[0]["uneven"]
    assert "batch_size 6 must divide over 4 devices" in sharded[0]["dp_batch"]


def test_dp_step_matches_one_process(sharded, train_setup, monkeypatch):
    """Two steps over 2 and 4 ranks against loop.train_step on the same
    draws."""
    _, tparams, _, draws = train_setup
    it = iter(draws)
    monkeypatch.setattr(loop, "draw_batch",
                        lambda *a, **k: next(it))
    state = loop.build_state(TCFG, tparams, "cpu")
    losses = [float(loop.train_step(state, None, TCFG)["total"])
              for _ in draws]
    want = {k: v.numpy() for k, v in state.params.items()}
    for r, res in enumerate(sharded):
        for n in ("2", "4"):
            if f"{n}/dp" not in res:
                continue
            got_losses, got = res[f"{n}/dp"]
            np.testing.assert_allclose(got_losses, losses, rtol=1e-5)
            for k, v in want.items():
                np.testing.assert_allclose(got[k], v, atol=1e-6,
                                           err_msg=f"{k}, rank {r}, {n}")


def test_dp_step_draws_and_renders_once(sharded):
    """One profiled DP step over 2 and 4 ranks: one ``draw`` span (every
    rank draws the whole batch) and one ``render`` span on each rank."""
    for r, res in enumerate(sharded):
        for n in ("2", "4"):
            if f"{n}/dp" in res:
                assert res[f"{n}/dp_spans"] == {"dvsg.draw": 1,
                                                "dvsg.render": 1}, (r, n)


def test_dp_step_matches_reference_dp_step(sharded, train_setup):
    """The first step against the JAX package's make_dp_train_step on the
    8-device mesh, as tests/test_parallel.py holds its own."""
    jp, _, keys, _ = train_setup
    m = jmesh.make_mesh()
    opt = jloop.make_optimizer(JTCFG)
    state = jdp.replicate_state(
        jloop.TrainState(jp, opt.init(jp), jax.numpy.zeros((), "int32")), m)
    step_fn, shard_keys = jdp.make_dp_train_step(JTCFG, m)
    state, aux = step_fn(state, shard_keys(keys[0]))
    for n in ("2", "4"):
        got_losses, _ = sharded[0][f"{n}/dp"]
        np.testing.assert_allclose(got_losses[0], float(aux["total"]),
                                   rtol=1e-5)
    # The parameters after that step, through the port's step in one
    # process (the ranks' own are held against it above).
    jflat = ckpt.params_from_flax(_flat(jax.device_get(state.params)), MCFG)
    one = loop.build_state(TCFG, train_setup[1], "cpu")
    step1, _ = dp.make_dp_train_step(TCFG, mesh_lib.make_mesh(device="cpu"))
    step1(one, train_setup[3][0])
    for k, v in one.params.items():
        np.testing.assert_allclose(v.numpy(), jflat[k].numpy(), atol=1e-6,
                                   err_msg=k)


# --- stabilize_multi(mesh=) and stabilize-batch under two ranks --------------

def _write_dir(path, frames):
    with video_io.VideoWriter(str(path), frames.shape[2],
                              frames.shape[1]) as w:
        w.write_batch(frames)
    return str(path)


def _read_dir(path):
    with video_io.VideoReader(str(path)) as r:
        return r.read_batch(1000)


@pytest.fixture(scope="module")
def multi(params, tmp_path_factory):
    d = tmp_path_factory.mktemp("multi")
    clips = [_clip(n, key=20 + i) for i, n in enumerate((6, 5, 7, 4))]
    npz = str(d / "tiny.npz")
    ckpt.export_npz(npz, params, MCFG)
    ins = [_write_dir(d / f"in{i}", c) for i, c in enumerate(clips[:2])]
    outs = [str(d / f"out{i}") for i in range(2)]
    argv = ["stabilize-batch", "--inputs", *ins, "--outputs", *outs,
            "--checkpoint", npz, "--chunk-frames", "4", "--platform", "cpu",
            "--path-smooth", "8", "--metrics-out", str(d / "m.jsonl")]
    res = torch_ranks.spawn("multi", 2, d / "ranks",
                            dict(cfg=CFG, params=params, clips=clips,
                                 argv=argv, dir=str(d)))
    return res, clips, outs, str(d / "m.jsonl")


@pytest.mark.parametrize("mode", ["plain", "causal"])
def test_stabilize_multi_over_a_mesh(multi, params, mode):
    res, clips, _, _ = multi
    cfg = CFG.replace(**MODES[mode])
    writers = [torch_ranks.MemWriter() for _ in clips]
    want = multiclip.stabilize_multi(
        cfg, params, [torch_ranks.MemReader(c) for c in clips], writers,
        device="cpu")
    for r, rank_res in enumerate(res):
        frames, written, errors = rank_res[mode]
        assert written == want.frames_written == [len(c) for c in clips]
        assert errors == [None] * len(clips)
        for i, c in enumerate(clips):
            mine = i // 2 == r          # each rank writes its own clips
            if not mine:
                assert frames[i] is None
                continue
            np.testing.assert_array_equal(frames[i], writers[i].frames)
            np.testing.assert_array_equal(
                frames[i], Stabilizer(cfg, params, device="cpu")
                .stabilize_clip(c))


def test_stabilize_batch_over_two_ranks(multi, params):
    import json
    res, clips, outs, metrics = multi
    assert [r["cli"] for r in res] == [0, 0]
    stab = Stabilizer(CFG.replace(path_smooth=8), params, device="cpu")
    for clip, out in zip(clips, outs):
        np.testing.assert_array_equal(_read_dir(out),
                                      stab.stabilize_clip(clip))
    with open(metrics) as f:
        recs = [json.loads(line) for line in f]
    assert len(recs) == 1               # rank 0 writes the record
    assert (recs[0]["devices"], recs[0]["mesh"], recs[0]["clips"],
            recs[0]["frames"]) == (2, True, 2, len(clips[0]) + len(clips[1]))


def test_batch_artifact_over_a_mesh(multi, params):
    """A batch artifact exported for a mesh of two: each rank runs its two
    clips, every rank gets all four, byte-equal to one process."""
    res, clips, _, _ = multi
    single = Stabilizer(CFG, params, device="cpu")
    want = np.stack([single.stabilize_clip(c[:4]) for c in clips])
    for nr_devices, n_clips, out in (r["artifact"] for r in res):
        assert (nr_devices, n_clips) == (2, 4)
        np.testing.assert_array_equal(out, want)


def test_stabilize_batch_summary_keys_in_one_process(params, tmp_path):
    import json
    npz = str(tmp_path / "tiny.npz")
    ckpt.export_npz(npz, params, MCFG)
    ins = [_write_dir(tmp_path / f"in{i}", _clip(4, key=30 + i))
           for i in range(2)]
    outs = [str(tmp_path / f"out{i}") for i in range(2)]
    assert cli.main(["stabilize-batch", "--inputs", *ins, "--outputs", *outs,
                     "--checkpoint", npz, "--chunk-frames", "4",
                     "--platform", "cpu", "--metrics-out",
                     str(tmp_path / "m.jsonl")]) == 0
    with open(tmp_path / "m.jsonl") as f:
        rec = json.loads(f.readline())
    assert (rec["devices"], rec["mesh"]) == (1, False)


def test_dryrun_multichip_two_ranks(capsys):
    dryrun.dryrun_multichip(2, timeout_s=240)
    out = capsys.readouterr().out
    assert "spawning 2 gloo ranks on the CPU" in out
