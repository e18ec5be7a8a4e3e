"""The port's batch surfaces on the CPU: the batched chunk step
(pipeline/stabilize.py's ``ChunkStep``), the clip-batch driver,
``BatchStabilizer``, ``stabilize_multi`` and the batched auto-crop scan.

Every batched output is byte-identical to the port's single-clip
``Stabilizer`` on the same clip, and within 1 LSB of the JAX package's
batched run on the same weights (mirrors of tests/test_serve.py,
tests/test_multiclip.py and tests/test_autocrop.py).
"""

import concurrent.futures
import threading

import numpy as np
import pytest
import torch

from dvsg_tpu.config import ModelConfig as JModelConfig
from dvsg_tpu.config import StabilizeConfig as JStabilizeConfig
from dvsg_tpu.pipeline import autocrop as jautocrop
from dvsg_tpu.pipeline.batching import BatchStabilizer as JBatchStabilizer
from dvsg_tpu.pipeline.multiclip import stabilize_multi as jstabilize_multi
from dvsg_tpu.utils import checkpoint as jckpt
from dvsg_tpu_torch.config import ModelConfig, StabilizeConfig
from dvsg_tpu_torch.models import motion_cnn
from dvsg_tpu_torch.ops import grouped
from dvsg_tpu_torch.pipeline import autocrop
from dvsg_tpu_torch.pipeline import multiclip as mc
from dvsg_tpu_torch.pipeline import stabilize as st
from dvsg_tpu_torch.pipeline.batching import BatchStabilizer
from dvsg_tpu_torch.train import synthetic
from dvsg_tpu_torch.utils.checkpoint import export_npz

MCFG = ModelConfig(window=3, model_size=(32, 32), grid_size=(8, 8),
                   base_features=8, blocks_per_level=1)
CFG = StabilizeConfig(model=MCFG, chunk_frames=4)
JCFG = JStabilizeConfig(model=JModelConfig(
    window=3, model_size=(32, 32), grid_size=(8, 8), base_features=8,
    blocks_per_level=1), chunk_frames=4, warp_impl="lax")
MODES = {"plain": {}, "causal": dict(path_smooth=8),
         "lag": dict(path_smooth=8, path_smooth_lag=4)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    """The tiny model with a head that moves pixels."""
    gen = torch.Generator().manual_seed(0)
    p = motion_cnn.init_params(MCFG, gen)
    p["head_out.weight"] = 0.05 * torch.randn(p["head_out.weight"].shape,
                                              generator=gen)
    return p


@pytest.fixture(scope="module")
def jparams(params, tmp_path_factory):
    """The same weights in the JAX package's format."""
    path = str(tmp_path_factory.mktemp("w") / "tiny.npz")
    export_npz(path, params, MCFG)
    return jckpt.load_npz(path)[0]


def _clip(n, key=3, h=40, w=48):
    return synthetic.synthetic_clip_u8(torch.Generator().manual_seed(key),
                                       n, h, w)[0].numpy()


def _single(cfg, params, clip):
    return st.Stabilizer(cfg, params, device="cpu").stabilize_clip(clip)


def _lsb(a, b):
    return int(np.abs(a.astype(int) - b).max())


# --- batched chunk steps and drivers -----------------------------------------

@pytest.mark.parametrize("mode", list(MODES))
def test_batched_step_equals_single_steps(params, mode):
    """Every output of one batched step (frames, halos, offsets, and the
    smoothing state or lag carries it holds) equals the single-clip
    step's, clip by clip."""
    cfg = CFG.replace(**MODES[mode])
    rng = np.random.default_rng(1)
    frames = torch.from_numpy(np.stack([_clip(4, key=k) for k in (1, 2, 3)]))
    model = st.build_model(MCFG, params, torch.device("cpu"))
    with torch.inference_mode():
        halos = torch.stack([st.initial_halo(cfg, f[0].numpy(), "cpu")
                             for f in frames])
        halos = halos + torch.from_numpy(
            rng.normal(0, 0.01, halos.shape).astype(np.float32))
        step = st.ChunkStep(cfg, model, batched=True)
        singles = [st.ChunkStep(cfg, model) for _ in range(3)]
        if mode == "causal":
            states = torch.from_numpy(
                rng.normal(0, 0.01, (3, 4)).astype(np.float32))
            step.carry = (states,)
            for i, single in enumerate(singles):
                single.carry = (states[i],)
        batched = [*step(frames, halos), *step.carry]
        singles = [[*single(frames[i], halos[i]), *single.carry]
                   for i, single in enumerate(singles)]
    assert len(batched) == len(singles[0])
    for j, b in enumerate(batched):
        for i in range(3):
            assert torch.equal(b[i], singles[i][j]), (j, i)
    with pytest.raises(ValueError, match="B, T, H, W, C"):
        st.ChunkStep(cfg, model, batched=True)(frames[0], halos[0])


def test_in_groups_makes_fixed_size_calls():
    """The card's per-frame stages run in calls of a fixed frame count, a
    short last call padded with its last frame; the CPU makes one call."""
    calls = []

    def double(v):
        calls.append(len(v))
        return v * 2

    x = torch.arange(10.0)[:, None]
    np.testing.assert_array_equal(
        grouped.in_groups(double, x, 4, grouped=True).numpy(),
        (x * 2).numpy())
    assert calls == [4, 4, 4]
    calls.clear()
    grouped.in_groups(double, x, 4)
    assert calls == [10]


@pytest.mark.parametrize("mode", list(MODES))
def test_drivers_equal_single_clips(params, mode):
    """The clip-batch driver on a pow2-padded batch (3 real clips + one
    pad slot, fetch_clips=3) gives each clip's single-clip output."""
    cfg = CFG.replace(**MODES[mode])
    clips = np.stack([_clip(10, key=k) for k in (4, 5, 6)])
    batch = np.concatenate([clips, clips[:1]])
    model = st.build_model(MCFG, params, torch.device("cpu"))
    out = st.drive_chunked_batch(st.ChunkStep(cfg, model, batched=True),
                                 batch, fetch_clips=3)
    assert out.shape == clips.shape
    for i in range(3):
        np.testing.assert_array_equal(out[i], _single(cfg, params, clips[i]))


def test_driver_halo_carry_equals_one_pass(params):
    """A batch driven in two chunk-aligned segments, the second seeded with
    the first's returned halos, equals one pass."""
    clips = np.stack([_clip(12, key=k) for k in (7, 8)])
    model = st.build_model(MCFG, params, torch.device("cpu"))
    whole = st.drive_chunked_batch(st.ChunkStep(CFG, model, batched=True),
                                   clips)
    step = st.ChunkStep(CFG, model, batched=True)
    first, halos = st.drive_chunked_batch(step, clips[:, :8],
                                          return_halos=True)
    second = st.drive_chunked_batch(step, clips[:, 8:],
                                    initial_halos=halos.numpy())
    np.testing.assert_array_equal(np.concatenate([first, second], axis=1),
                                  whole)


# --- BatchStabilizer ---------------------------------------------------------

def _concurrent(engine, clips, **kw):
    with concurrent.futures.ThreadPoolExecutor(len(clips)) as ex:
        return list(ex.map(lambda c: engine.stabilize_clip(c, **kw), clips))


def test_engine_matches_single_and_reference(params, jparams):
    """Three concurrent clips of mixed lengths form one group padded to a
    batch of four: each output equals the single-clip run, and is within
    1 LSB of the JAX package's engine on the same weights."""
    clips = [_clip(n, key=k) for n, k in ((9, 9), (5, 10), (7, 11))]
    engine = BatchStabilizer(CFG, params, max_batch=3, window_s=5.0,
                             device="cpu")
    try:
        outs = _concurrent(engine, clips)
        assert engine.stats["max_group"] == 3
        assert engine.stats["batches"] == 1
    finally:
        engine.close()
    ref_engine = JBatchStabilizer(JCFG, jparams, max_batch=3, window_s=5.0)
    try:
        refs = _concurrent(ref_engine, clips)
    finally:
        ref_engine.close()
    for clip, out, ref in zip(clips, outs, refs):
        assert out.shape == clip.shape and out.dtype == np.uint8
        np.testing.assert_array_equal(out, _single(CFG, params, clip))
        assert _lsb(out, ref) <= 1
    assert any(np.abs(o.astype(int) - c).mean() > 1 for o, c in
               zip(outs, clips))                  # the model moves pixels


@pytest.mark.parametrize("mode", ["causal", "lag"])
def test_engine_smoothing_modes_match_single(params, mode):
    cfg = CFG.replace(**MODES[mode])
    clips = [_clip(n, key=k) for n, k in ((11, 12), (6, 13))]
    engine = BatchStabilizer(cfg, params, max_batch=2, window_s=5.0,
                             device="cpu")
    try:
        outs = _concurrent(engine, clips)
        assert engine.stats["max_group"] == 2
    finally:
        engine.close()
    for clip, out in zip(clips, outs):
        np.testing.assert_array_equal(out, _single(cfg, params, clip))


def test_engine_mixed_resolutions(params):
    """A group with two resolutions splits into one step per resolution."""
    clips = [_clip(6, key=14), _clip(6, key=15, h=32, w=64),
             _clip(6, key=16)]
    engine = BatchStabilizer(CFG, params, max_batch=3, window_s=5.0,
                             device="cpu")
    try:
        outs = _concurrent(engine, clips)
        assert engine.stats["batches"] == 2
    finally:
        engine.close()
    for clip, out in zip(clips, outs):
        np.testing.assert_array_equal(out, _single(CFG, params, clip))


def test_engine_groups_by_crop(params):
    """Per-request crops: each group's output equals the single-clip run at
    that crop; the engine's own crop is its default."""
    clips = [_clip(6, key=17), _clip(6, key=18), _clip(6, key=19)]
    crops = [3 / 64, None, 3 / 64]
    engine = BatchStabilizer(CFG, params, max_batch=3, window_s=5.0,
                             device="cpu")
    try:
        with concurrent.futures.ThreadPoolExecutor(3) as ex:
            outs = list(ex.map(lambda a: engine.stabilize_clip(
                a[0], border_crop=a[1]), zip(clips, crops)))
        assert engine.stats["batches"] == 2
        assert engine.stats["crops_seen"] == [3 / 64]
        engine.window_s = 0.0
        out0 = engine.stabilize_clip(clips[1], border_crop=0.0)
    finally:
        engine.close()
    for clip, crop, out in zip(clips, crops, outs):
        np.testing.assert_array_equal(out, _single(
            CFG.replace(border_crop=crop or 0.0), params, clip))
    np.testing.assert_array_equal(out0, outs[1])


def test_engine_carry_threading_equals_one_call(params):
    """Segments threaded through the carry API equal one call, also when a
    carried segment shares a group with a fresh first segment."""
    cfg = CFG.replace(**MODES["causal"])
    a, b = _clip(16, key=20), _clip(16, key=21)
    engine = BatchStabilizer(cfg, params, max_batch=2, window_s=0.0,
                             device="cpu")
    try:
        a1, carry = engine.stabilize_clip(a[:8], return_carry=True)
        assert carry[0].shape == (2, 32, 32, 3) and carry[1].shape == (4,)
        engine.window_s = 5.0
        with concurrent.futures.ThreadPoolExecutor(2) as ex:
            fa = ex.submit(engine.stabilize_clip, a[8:], None, carry)
            fb = ex.submit(engine.stabilize_clip, b[:8], None, None, True)
            a2, (b1, _) = fa.result(), fb.result()
        assert engine.stats["max_group"] == 2
    finally:
        engine.close()
    np.testing.assert_array_equal(np.concatenate([a1, a2]),
                                  _single(cfg, params, a))
    np.testing.assert_array_equal(b1, _single(cfg, params, b)[:8])


@pytest.mark.parametrize("kw,call,err,match", [
    ({}, dict(frames_u8=np.zeros((4, 32, 48, 3), np.float32)), TypeError,
     "uint8"),
    ({}, dict(border_crop=0.017), ValueError, "multiple of 1/64"),
    ({}, dict(border_crop=0.75), ValueError, "border_crop"),
    ({}, dict(return_carry=True), ValueError, "path-smoothing"),
    (MODES["lag"], dict(return_carry=True), ValueError, "path_smooth_lag"),
    (MODES["causal"], dict(frames_u8=np.zeros((6, 32, 48, 3), np.uint8),
                           return_carry=True), ValueError, "multiple of"),
    (MODES["causal"], dict(carry=(np.zeros((2, 32, 32, 3)), np.zeros(2))),
     ValueError, "smooth_state"),
], ids=["non-uint8", "off-grid-crop", "crop-range", "carry-unsmoothed",
        "carry-lag", "carry-unaligned", "carry-state-shape"])
def test_engine_refusals(params, kw, call, err, match):
    engine = BatchStabilizer(CFG.replace(**kw), params, max_batch=2,
                             window_s=0.0, device="cpu")
    call = dict(call)
    frames = call.pop("frames_u8", np.zeros((4, 32, 48, 3), np.uint8))
    try:
        with pytest.raises(err, match=match):
            engine.stabilize_clip(frames, **call)
        assert engine.stats["requests"] == 0
    finally:
        engine.close()


def test_engine_close_rejects_new_requests(params):
    engine = BatchStabilizer(CFG, params, max_batch=2, window_s=0.0,
                             device="cpu")
    frames = _clip(4, key=22)
    engine.stabilize_clip(frames)
    engine.close()
    with pytest.raises(RuntimeError, match="closed"):
        engine.stabilize_clip(frames)
    engine.close()                          # idempotent


# --- stabilize_multi ---------------------------------------------------------

class _Reader:
    """An in-memory reader (the VideoReader methods the drivers use)."""

    def __init__(self, frames, fail_after=None):
        self.frames, self.pos, self.calls = frames, 0, 0
        self.height, self.width = frames.shape[1:3]
        self.shape = (self.height, self.width)
        self.fps = 30.0
        self.fail_after = fail_after

    def read_batch(self, n):
        self.calls += 1
        if self.fail_after is not None:
            n = min(n, self.fail_after - self.pos)
            if n <= 0:
                raise IOError("injected mid-stream decode failure")
        out = self.frames[self.pos:self.pos + n]
        self.pos += len(out)
        return out


class _Writer:
    def __init__(self, fail_after=None):
        self.frames, self.fail_after = [], fail_after

    def write_batch(self, frames):
        if self.fail_after is not None \
                and sum(map(len, self.frames)) >= self.fail_after:
            raise IOError("injected mid-stream encode failure")
        self.frames.append(np.array(frames))

    @property
    def out(self):
        return np.concatenate(self.frames)


def _multi(cfg, params, clips, readers=None, writers=None, **kw):
    readers = readers or [_Reader(c) for c in clips]
    writers = writers or [_Writer() for _ in clips]
    res = mc.stabilize_multi(cfg, params, readers, writers, device="cpu",
                             **kw)
    return res, writers


@pytest.mark.parametrize("mode", ["plain", "causal"])
def test_multi_matches_single(params, jparams, mode):
    """Unequal-length clips through the batched streaming driver equal the
    single-clip run per clip; the plain run is within 1 LSB of the JAX
    package's stabilize_multi."""
    cfg = CFG.replace(**MODES[mode])
    clips = [_clip(n, key=k) for n, k in ((10, 23), (6, 24), (4, 25),
                                          (8, 26))]
    res, writers = _multi(cfg, params, clips)
    assert res.ok and res.frames_written == [10, 6, 4, 8]
    assert res.coverage_fallback_chunks == [0] * 4
    for clip, w in zip(clips, writers):
        np.testing.assert_array_equal(w.out, _single(cfg, params, clip))
    if mode == "plain":
        jw = [_Writer() for _ in clips]
        jres = jstabilize_multi(JCFG, jparams, [_Reader(c) for c in clips],
                                jw)
        assert jres.ok
        for w, j in zip(writers, jw):
            assert _lsb(w.out, j.out) <= 1


def test_multi_refusals(params):
    clips = [_clip(4, key=27), _clip(4, key=28, h=32, w=64)]
    with pytest.raises(ValueError, match="one resolution"):
        _multi(CFG, params, clips)
    with pytest.raises(ValueError, match="path_smooth_lag"):
        _multi(CFG.replace(**MODES["lag"]), params, clips[:1])
    from dvsg_tpu_torch.parallel.mesh import Mesh
    two = Mesh((2,), ("data",), 0, torch.device("cpu"))
    with pytest.raises(ValueError, match="mesh's 2 devices"):
        _multi(CFG, params, clips[:1], mesh=two)


def test_failed_decode_is_isolated(params):
    """One clip's mid-stream decode failure leaves the rest byte-identical,
    and the result names the failure and its resume point."""
    clips = [_clip(10, key=k) for k in (29, 30, 31, 32)]
    readers = [_Reader(c) for c in clips]
    readers[1].fail_after = 4
    res, writers = _multi(CFG, params, clips, readers=readers)
    assert res.failed_clips == [1] and isinstance(res.errors[1], IOError)
    assert res.frames_written[1] == 4
    for i in (0, 2, 3):
        assert res.frames_written[i] == 10
        np.testing.assert_array_equal(writers[i].out,
                                      _single(CFG, params, clips[i]))


def test_failed_encoder_is_isolated_and_stops_decode(params):
    """A clip whose encoder fails counts only the frames that landed and
    stops decoding early; the other clip finishes byte-identical."""
    clips = [_clip(200, key=33, h=16, w=24), _clip(12, key=34, h=16, w=24)]
    readers = [_Reader(c) for c in clips]
    writers = [_Writer(fail_after=4), _Writer()]
    res, _ = _multi(CFG, params, clips, readers=readers, writers=writers)
    assert res.failed_clips == [0]
    assert res.frames_written == [4, 12]
    assert sum(map(len, writers[0].frames)) == 4
    assert readers[0].calls < 25, readers[0].calls
    np.testing.assert_array_equal(writers[1].out,
                                  _single(CFG, params, clips[1]))


def test_all_clips_failing_raises(params):
    clip = _clip(8, key=35)
    with pytest.raises(IOError):
        _multi(CFG, params, [clip], readers=[_Reader(clip, fail_after=0)])


def test_device_failure_cleans_up_workers(params, monkeypatch):
    """A device-step failure stops and joins every worker thread before it
    escapes."""
    clips = [_clip(12, key=36), _clip(12, key=37)]
    calls = {"n": 0}
    real_put = mc.put_frames

    def failing_put(x, device):
        calls["n"] += 1
        if calls["n"] >= 2:
            raise RuntimeError("injected device failure")
        return real_put(x, device)

    monkeypatch.setattr(mc, "put_frames", failing_put)
    before = set(threading.enumerate())
    with pytest.raises(RuntimeError, match="injected device failure"):
        _multi(CFG, params, clips)
    leftover = [t for t in threading.enumerate()
                if t not in before and t.is_alive()]
    assert not leftover, f"driver leaked worker threads: {leftover}"


# --- batched auto-crop scan --------------------------------------------------

def test_scan_readers_matches_reference_and_single_scans(params, jparams):
    """The lockstep scan of clips of unequal lengths equals the max of the
    single-clip scans, and the JAX package's batched scan within f32
    rounding."""
    clips = [_clip(n, key=k, h=40, w=48) for n, k in ((10, 38), (5, 39),
                                                       (7, 40))]
    m = autocrop.scan_readers_max_offset(
        CFG, params, [_Reader(c) for c in clips], device="cpu")
    singles = [autocrop.scan_clip_max_offset(CFG, params, c, device="cpu")
               for c in clips]
    assert m == max(singles) > 0
    m_ref = jautocrop.scan_readers_max_offset(
        JCFG, jparams, [_Reader(c) for c in clips])
    assert m == pytest.approx(m_ref, abs=1e-5)
    assert autocrop.scan_readers_max_offset(CFG, params, [],
                                            device="cpu") == 0.0
