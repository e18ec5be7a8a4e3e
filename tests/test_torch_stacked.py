"""The stacked arch (``ModelConfig.arch="stacked"``) of the port against the
JAX package on the CPU, in f32, at a narrow width.

Weights cross through ``params_from_flax`` from a seeded flax init with
numpy noise on every leaf (so the zero ``head_out`` does not silence the
model). Offsets hold 1e-5; frames through the reference's lax
``Stabilizer`` (plain, causal, lag) hold 1 LSB; the port is byte-identical
to itself across chunk size, resume, batching, temporal sharding and its
exported artifact; one loss step holds rtol 1e-5 and every parameter
gradient 2e-5 of its tensor's largest (the corr arch's bounds).
"""

import dataclasses

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
from dvsg_tpu.pipeline import stabilize as jstab
from dvsg_tpu.train import loop as jloop
from dvsg_tpu.train import synthetic as jsyn
from dvsg_tpu.utils import checkpoint as jckpt
from dvsg_tpu_torch import export as texport
from dvsg_tpu_torch.config import ModelConfig, StabilizeConfig, TrainConfig
from dvsg_tpu_torch.models import motion_cnn as tcnn
from dvsg_tpu_torch.parallel import mesh as tmesh
from dvsg_tpu_torch.parallel.temporal import TemporalShardedStabilizer
from dvsg_tpu_torch.pipeline import stabilize as tstab
from dvsg_tpu_torch.pipeline.multiclip import stabilize_multi
from dvsg_tpu_torch.train import eval as teval
from dvsg_tpu_torch.train import loop as tloop
from dvsg_tpu_torch.utils import checkpoint as tckpt

MKW = dict(window=3, model_size=(32, 32), grid_size=(8, 8),
           base_features=8, blocks_per_level=1, max_offset=0.15,
           arch="stacked")
MCFG, JMCFG = ModelConfig(**MKW), JModelConfig(**MKW)
TKW = dict(batch_size=2, steps=4, warmup_steps=1, learning_rate=1e-3,
           checkpoint_every=0)
MODES = {"plain": {}, "causal": dict(path_smooth=8),
         "lag": dict(path_smooth=8, path_smooth_lag=4)}


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


@pytest.fixture(scope="module")
def weights():
    """(flax tree, port state dict): a seeded init, perturbed."""
    params = jcnn.init_params(JMCFG, jax.random.key(5))
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(
            np.float32), params)
    return params, tckpt.params_from_flax(_flat(params), MCFG)


@pytest.fixture(scope="module")
def clip():
    frames, _, _ = jsyn.synthetic_clip_u8(jax.random.key(3), 10, 48, 64)
    return np.array(frames)


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


def _model(sd, cfg=MCFG):
    model = tcnn.MotionEstimator(cfg)
    model.load_state_dict(sd)
    return model.eval()


def test_init_params_has_the_reference_layout():
    """The stacked trunk sits at the top scope (stem, down{l}, res{l}_{b},
    head_conv, head_out), as in the reference's tree; head_out starts at
    zero."""
    ref = _flat(jcnn.init_params(JMCFG, jax.random.key(0)))
    ours = tcnn.init_params(MCFG, torch.Generator().manual_seed(0))
    mapped = tckpt.params_from_flax(ref, MCFG)
    assert set(mapped) == set(ours)
    assert {k.split(".")[0] for k in ours} == {
        "stem", "down0", "down1", "res0_0", "res1_0", "head_conv",
        "head_out"}
    for k, v in ours.items():
        assert v.shape == mapped[k].shape, k
    assert not ours["head_out.weight"].any()
    assert ours["stem.weight"].shape == (8, 9, 7, 7)      # window * C in


def test_predict_offsets_matches_reference(weights):
    params, sd = weights
    w = np.random.default_rng(0).uniform(-0.5, 0.5, (3, 32, 32, 9)
                                         ).astype(np.float32)
    ref = np.asarray(jcnn.predict_offsets(JMCFG, params, jnp.asarray(w)))
    with torch.no_grad():
        ours = tcnn.predict_offsets(_model(sd), torch.from_numpy(w)).numpy()
    assert ours.shape == ref.shape == (3, 8, 8, 2)
    assert np.abs(ref).max() > 1e-3                       # not silent
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


def test_encode_frames_refuses_stacked_as_the_reference(weights):
    params, sd = weights
    frames = np.zeros((1, 32, 32, 3), np.float32)
    with pytest.raises(ValueError, match="corr architecture"):
        jcnn.encode_frames(JMCFG, params, jnp.asarray(frames))
    with pytest.raises(ValueError, match="corr architecture"):
        tcnn.encode_frames(_model(sd), torch.from_numpy(frames))


def test_build_windows_matches_reference():
    seq = np.random.default_rng(1).random((6, 4, 5, 3)).astype(np.float32)
    ref = np.asarray(jstab.build_windows(jnp.asarray(seq), 4, 3))
    ours = tstab.build_windows(torch.from_numpy(seq), 4, 3).numpy()
    np.testing.assert_array_equal(ours, ref)
    # With a leading clip axis: each clip's own windows.
    two = tstab.build_windows(torch.from_numpy(np.stack([seq, seq[::-1]
                                                         .copy()])), 4, 3)
    np.testing.assert_array_equal(two[0].numpy(), ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_cross_both_ways(weights, tmp_path, dtype):
    """A stacked (and stacked-bf16) checkpoint the port writes loads in the
    reference, and one the reference writes loads in the port: the same
    arrays, arch and dtype."""
    params, sd = weights
    cfg = dataclasses.replace(MCFG, dtype=dtype)
    jcfg = dataclasses.replace(JMCFG, dtype=dtype)
    ours = str(tmp_path / "port.npz")
    tckpt.export_npz(ours, sd, cfg)
    got, got_cfg = jckpt.load_npz(ours)
    assert (got_cfg.arch, got_cfg.dtype) == ("stacked", dtype)
    for k, v in _flat(got).items():
        np.testing.assert_array_equal(v, _flat(params)[k])
    theirs = str(tmp_path / "ref.npz")
    jckpt.export_npz(theirs, params, jcfg)
    back, back_cfg = tckpt.load_npz(theirs)
    assert back_cfg == cfg
    for k, v in sd.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_clip_within_1lsb_of_reference(weights, clip, mode):
    params, sd = weights
    ref = jstab.Stabilizer(JStabilizeConfig(model=JMCFG, chunk_frames=4,
                                            warp_impl="lax", **MODES[mode]),
                           params).stabilize_clip(clip)
    ours = tstab.Stabilizer(StabilizeConfig(model=MCFG, chunk_frames=4,
                                            **MODES[mode]),
                            sd, device="cpu").stabilize_clip(clip)
    assert ours.shape == clip.shape and ours.dtype == np.uint8
    assert np.abs(ours.astype(int) - clip).mean() > 0.5   # pixels move
    assert np.abs(ours.astype(int) - ref).max() <= 1


class _Reader:
    def __init__(self, frames):
        self.frames, self.pos = frames, 0
        self.height, self.width = frames.shape[1:3]

    def read_batch(self, n):
        out = self.frames[self.pos:self.pos + n]
        self.pos += len(out)
        return out

    def skip(self, n):
        k = min(n, len(self.frames) - self.pos)
        self.pos += k
        return k


class _Writer:
    def __init__(self, shape, fail_at=None):
        self.frames, self.pos = np.zeros(shape, np.uint8), 0
        self.fail_at, self.calls = fail_at, 0

    def seek(self, i):
        self.pos = i

    def write_batch(self, frames):
        if self.calls == self.fail_at:
            raise RuntimeError("injected")
        self.calls += 1
        self.frames[self.pos:self.pos + len(frames)] = frames
        self.pos += len(frames)


@pytest.mark.parametrize("mode", ["plain", "lag"])
def test_chunk_size_and_resume_are_byte_identical(weights, clip, tmp_path,
                                                  mode):
    _, sd = weights
    cfg = StabilizeConfig(model=MCFG, chunk_frames=4, **MODES[mode])
    want = tstab.Stabilizer(cfg, sd, device="cpu").stabilize_clip(clip)
    t8 = tstab.Stabilizer(cfg.replace(chunk_frames=8), sd,
                          device="cpu").stabilize_clip(clip)
    np.testing.assert_array_equal(t8, want)
    stab = tstab.Stabilizer(cfg, sd, device="cpu")
    first = _Writer(clip.shape, fail_at=1)
    with pytest.raises(RuntimeError, match="injected"):
        stab.stabilize_stream(_Reader(clip), first, resume_dir=str(tmp_path))
    second = _Writer(clip.shape)
    second.frames[:] = first.frames
    assert stab.stabilize_stream(_Reader(clip), second,
                                 resume_dir=str(tmp_path)) == len(clip)
    np.testing.assert_array_equal(second.frames, want)


def test_batched_multiclip_temporal_and_export_equal_the_clip(
        weights, clip, tmp_path):
    """Every surface that calls predict_chunk_offsets runs the stacked arch
    and gives each clip the bytes of stabilize_clip: the batched step, the
    multi-clip driver, temporal sharding (one rank) and an exported
    artifact, whose header records the arch."""
    _, sd = weights
    cfg = StabilizeConfig(model=MCFG, chunk_frames=4)
    clips = np.stack([clip, clip[::-1].copy()])
    stab = tstab.Stabilizer(cfg, sd, device="cpu")
    want = [stab.stabilize_clip(c) for c in clips]
    got = tstab.drive_chunked_batch(
        tstab.ChunkStep(cfg, stab.model, batched=True), clips)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    writers = [_Writer(c.shape) for c in clips]
    res = stabilize_multi(cfg, sd, [_Reader(c) for c in clips], writers,
                          device="cpu")
    assert res.ok
    for wr, w in zip(writers, want):
        np.testing.assert_array_equal(wr.frames, w)
    mesh = tmesh.make_mesh(device="cpu")
    temporal = TemporalShardedStabilizer(cfg, sd, mesh)
    np.testing.assert_array_equal(temporal.stabilize_clip(clip), want[0])
    exp = texport.export_chunk_program(cfg, sd, 48, 64, device="cpu")
    path = str(tmp_path / "stacked.dvsgt")
    texport.save_exported(exp, path, cfg)
    loaded = texport.load_exported(path)
    assert loaded.cfg.model == MCFG   # the header's arch
    np.testing.assert_array_equal(loaded.stabilize_clip(clip), want[0])


def test_loss_step_matches_reference(weights, monkeypatch):
    """One loss step through the reference's build_windows branch: loss
    and every aux term rtol 1e-5, every parameter gradient within 2e-5 of
    its tensor's largest (lax oracle warp on the reference side)."""
    monkeypatch.setattr(jwarp, "resolve_impl", lambda _: "lax")
    params, sd = weights
    tcfg = TrainConfig(model=MCFG, **TKW)
    jtcfg = JTrainConfig(model=JMCFG, **TKW)
    keys = jax.random.split(jax.random.key(4), tcfg.batch_size)
    (want_total, want_aux), want_grads = jax.value_and_grad(
        jloop.loss_fn, has_aux=True)(params, keys, jtcfg)

    model = tcnn.MotionEstimator(MCFG)
    model.load_state_dict(sd)
    model.train()
    batch = tloop.render_batch(*_jax_draws(keys, jtcfg), tcfg)
    total, aux = tloop.loss_from_batch(model, batch, tcfg)
    total.backward()
    for k in aux:
        np.testing.assert_allclose(float(aux[k].detach()),
                                   float(want_aux[k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(float(total.detach()), float(want_total),
                               rtol=1e-5)
    want = tckpt.params_from_flax(_flat(want_grads), MCFG)
    worst = 0.0
    for name, p in model.named_parameters():
        scale = float(want[name].abs().max())
        assert scale > 0, name
        worst = max(worst, float((p.grad - want[name]).abs().max()) / scale)
    print(f"worst relative gradient error {worst:.2e}")
    assert worst <= 2e-5


def test_train_and_eval_run_the_stacked_arch(tmp_path):
    """train() from a seeded init with checkpoints the reference reads, and
    evaluate_synthetic on the result: finite reports."""
    tcfg = TrainConfig(model=MCFG, **{**TKW, "checkpoint_every": 2})
    history = []
    state = tloop.train(tcfg, checkpoint_dir=str(tmp_path), log_every=0,
                        device="cpu", history=history)
    assert len(history) == 4
    assert all(np.isfinite(v) for h in history for v in h.values())
    params, jcfg = jckpt.load_npz(str(tmp_path / "params" / "4.npz"))
    assert jcfg.arch == "stacked" and "head_conv" in params
    stab = tstab.Stabilizer(StabilizeConfig(model=MCFG, chunk_frames=4),
                            state.params, device="cpu")
    rep = teval.evaluate_synthetic(stab, torch.Generator().manual_seed(0),
                                   8, 32, 48)
    assert all(np.isfinite(v) for v in rep.values())
