"""The ``pwc`` arch (PWC-Net as the motion estimator) on the CPU, held to
the plain reference ``portbench/reference/pwc.py`` at the published
widths and radius 4, on a 64 x 64 input with a 4 x 4 grid and window 3:
its offsets, the training loss and every parameter's gradient, and the
stabilized chunk (``reference/stream_pwc.py``). Besides: byte identity
across batch and chunk sizes, the corr arch's cost volume unchanged by
the scale argument, the pyramid and pair counters, the checkpoint round
trip, the refusals, the two spans, ``_pwc_work`` against
``FlopCounterMode``, and the cell's three metrics on a hand-made trace.

The weights are the reference's seeded draw (``pwc.init``), whose
``head_out`` is not zero, so every gradient flows.
"""

import dataclasses
import os
import statistics
import sys

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from dvsg_tpu_torch import cli  # noqa: E402
from dvsg_tpu_torch import export as export_lib  # noqa: E402
from dvsg_tpu_torch.config import (StabilizeConfig, TrainConfig,  # noqa: E402
                                   model_config_from_dict)
from dvsg_tpu_torch.models import motion_cnn  # noqa: E402
from dvsg_tpu_torch.ops import grouped  # noqa: E402
from dvsg_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from dvsg_tpu_torch.parallel import tp  # noqa: E402
from dvsg_tpu_torch.pipeline import stabilize as st  # noqa: E402
from dvsg_tpu_torch.train import loop, synthetic  # noqa: E402
from dvsg_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from dvsg_tpu_torch.utils import metrics, video_io  # noqa: E402
from portbench import harness, tracing  # noqa: E402
from portbench.metrics import _pwc_work, _work  # noqa: E402
from portbench.reference import pwc, stream_pwc  # noqa: E402
# a raw profiler event as tracing.Trace reads one
from portbench.tests.test_portbench_drivers import _Ev  # noqa: E402

SMALL = {"arch": "pwc", "model_size": [64, 64], "grid_size": [4, 4],
         "window": 3, "corr_radius": 4, "channels": 3, "dtype": "float32",
         "max_offset": 0.2}
MCFG = model_config_from_dict(SMALL)
SEEDS = (0, 1, 2)
# Tolerances, with the readings measured on an x86 CPU over SEEDS in
# brackets. The port and the reference compute the same float32 ops in
# other orders (the pairs batched or one window's, the volume scaled by
# 1 / C or divided by C, the head's pad), so they part by rounding alone:
# offsets 1.7e-8 to 3.0e-8 apart (of 0.011 to 0.021). Each fault moves
# them by at least 1.6e-5: level 4's warp left out 1.6e-5 to 5.2e-5,
# level 3's 4.5e-5 to 1.2e-4, level 2's 6.3e-5 to 1.3e-4, the context
# network 5.9e-4 to 6.6e-4. (At 64 x 64, level 5 is 2 x 2 and the flow
# above it under 1e-8 pixels, so its warp moves nothing; at the cell's
# 256 x 256 it does.) OFFSET_TOL sits 30 times from both.
OFFSET_TOL = 5e-7
# A gradient's gap over max(its norm, the median leaf's norm): the
# port's worst leaf 3.2e-4 (the context network's first conv), the
# median 1.5e-5: float32 rounding through ~40 layers and their
# transposes. The context network left out moves them by far more (the
# leaves inside it lose their gradient: a gap of 1).
GRAD_TOL = 3e-3
# The loss's relative gap: 1.1e-7.
LOSS_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(seed=0, cfg=MCFG):
    params = pwc.init(dataclasses.asdict(cfg), seed)
    model = motion_cnn.MotionEstimator(cfg)
    model.load_state_dict(params)
    return model.eval(), params


def _seq(seed, n=6):
    gen = torch.Generator().manual_seed(100 + seed)
    return torch.rand(n, 64, 64, 3, generator=gen) - 0.5


def _clip(n, key=3, h=48, w=64):
    return synthetic.synthetic_clip_u8(torch.Generator().manual_seed(key),
                                       n, h, w)[0].numpy()


def _skip_warp(level):
    """Level ``level``'s feature warp by a zero flow (4 warps a pass, the
    first at level 5)."""
    orig, calls = motion_cnn.feature_warp, [0]

    def warp(x, flow):
        i = calls[0] % 4
        calls[0] += 1
        return orig(x, torch.zeros_like(flow) if 5 - i == level else flow)
    return warp


def _port_offsets(model, seq, t=4):
    cfg = StabilizeConfig(model=model.cfg, chunk_frames=t)
    with torch.no_grad():
        return st.predict_chunk_offsets(cfg, model, seq, t)


@pytest.fixture(scope="module")
def offsets():
    """Per seed: the port's, the reference's and the faults' offsets of
    a 4-window chunk."""
    out = {}
    for seed in SEEDS:
        model, params = _model(seed)
        seq = _seq(seed)
        rec = {"port": _port_offsets(model, seq)}
        with torch.no_grad():
            rec["ref"] = pwc.window_offsets(params, SMALL, seq, 4)
        for level in (4, 3, 2):
            warp = _skip_warp(level)
            orig, motion_cnn.feature_warp = motion_cnn.feature_warp, warp
            try:
                rec[f"warp{level}"] = _port_offsets(model, seq)
            finally:
                motion_cnn.feature_warp = orig
        hook = model.dc_conv7.register_forward_hook(
            lambda mod, args, y: torch.zeros_like(y))
        rec["context"] = _port_offsets(model, seq)
        hook.remove()
        out[seed] = rec
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_offsets_against_the_reference(offsets, seed):
    rec = offsets[seed]
    assert rec["ref"].abs().max() > 1e-3           # the head moves pixels
    assert (rec["port"] - rec["ref"]).abs().max() <= OFFSET_TOL


@pytest.mark.parametrize("fault", ["warp4", "warp3", "warp2", "context"])
def test_each_fault_exceeds_the_offsets_tolerance(offsets, fault):
    for seed in SEEDS:
        rec = offsets[seed]
        assert (rec[fault] - rec["ref"]).abs().max() > 10 * OFFSET_TOL


def test_the_reference_faults_agree_with_the_ports(offsets):
    """The reference's own switches leave out what the port's faults
    leave out: the context network, and every warp."""
    model, params = _model(0)
    seq = _seq(0)
    with torch.no_grad():
        ctx = pwc.window_offsets(params, SMALL, seq, 4, context=False)
        warps = pwc.window_offsets(params, SMALL, seq, 4, warps=False)
    assert (ctx - offsets[0]["context"]).abs().max() <= OFFSET_TOL
    orig = motion_cnn.feature_warp
    motion_cnn.feature_warp = lambda x, f: orig(x, torch.zeros_like(f))
    try:
        got = _port_offsets(model, seq)
    finally:
        motion_cnn.feature_warp = orig
    assert (warps - got).abs().max() <= OFFSET_TOL


def _grad_gaps(model, params, batch, tcfg, context=True):
    model.zero_grad(set_to_none=True)
    hook = None if context else model.dc_conv7.register_forward_hook(
        lambda mod, args, y: torch.zeros_like(y))
    total, _ = loop.loss_from_batch(model, batch, tcfg)
    total.backward()
    if hook:
        hook.remove()
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    weights = {"pixel": tcfg.pixel_weight, "offset": tcfg.offset_weight,
               "smooth": tcfg.smooth_weight, "reg": tcfg.reg_weight}
    want, _ = pwc.loss(leaves, SMALL, batch, weights)
    grads = torch.autograd.grad(want, list(leaves.values()))
    norms = {k: float(g.norm()) for k, g in zip(leaves, grads)}
    median = statistics.median(norms.values())
    named = dict(model.named_parameters())
    gaps = {k: float(((named[k].grad if named[k].grad is not None else 0.0)
                      - g).norm()) / max(norms[k], median)
            for k, g in zip(leaves, grads)}
    total, want = float(total.detach()), float(want.detach())
    return abs(total - want) / want, gaps


@pytest.fixture(scope="module")
def train_batch():
    tcfg = TrainConfig(model=MCFG, batch_size=2)
    gen = torch.Generator().manual_seed(3)
    return tcfg, loop.render_batch(*loop.draw_batch(gen, tcfg), tcfg)


def test_loss_and_every_gradient_against_the_reference(train_batch):
    tcfg, batch = train_batch
    model, params = _model(0)
    model.train()
    loss_gap, gaps = _grad_gaps(model, params, batch, tcfg)
    assert loss_gap <= LOSS_TOL
    assert len(gaps) == len(params) == len(list(model.parameters()))
    assert max(gaps.values()) <= GRAD_TOL, max(gaps, key=gaps.get)
    # and without the context network the gradients part
    _, bad = _grad_gaps(model, params, batch, tcfg, context=False)
    assert max(bad.values()) > 100 * GRAD_TOL


def test_a_stabilized_chunk_within_one_lsb_of_the_reference():
    """The clip through ``Stabilizer`` (two chunks, the halo between them)
    against the reference chunk by chunk, rounded: at most one step of
    255 apart (the offsets' rounding moves a sample across a rounding
    boundary now and then)."""
    _, params = _model(1)
    frames = _clip(8)
    stab = st.Stabilizer(StabilizeConfig(model=MCFG, chunk_frames=4),
                         params, device="cpu")
    got = stab.stabilize_clip(frames)
    want = []
    for k in range(2):
        prev = torch.from_numpy(frames[4 * k - 4:4 * k]) if k else None
        out = stream_pwc.chunk(params, SMALL,
                               torch.from_numpy(frames[4 * k:4 * k + 4]),
                               prev)
        want.append(torch.round(out * 255.0).clamp(0, 255).to(torch.uint8))
    want = torch.cat(want).numpy()
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1
    assert (frames != got).mean() > 0.5               # it moved the frames


def test_chunks_are_byte_identical_across_batch_and_chunk_sizes():
    """Two clips batched give each clip's bytes alone, a clip in chunks of
    2 gives its bytes in chunks of 4, and the pyramid in fixed-size calls
    (``in_groups``, as on the card) gives its bytes in one call."""
    _, params = _model(2)
    clips = np.stack([_clip(4, key=5), _clip(4, key=6)])
    cfg = StabilizeConfig(model=MCFG, chunk_frames=4)
    model = st.build_model(MCFG, params, torch.device("cpu"))
    frames = torch.from_numpy(clips)
    halos = torch.stack([st.initial_halo(cfg, c[0], "cpu") for c in clips])
    with torch.inference_mode():
        batched = st.ChunkStep(cfg, model, batched=True)(frames, halos)
        for i in range(2):
            single = st.ChunkStep(cfg, model)(frames[i], halos[i])
            for b, s in zip(batched, single):
                assert torch.equal(b[i], s)
    whole = st.Stabilizer(cfg, params, device="cpu").stabilize_clip(
        clips[0])
    halves = st.Stabilizer(cfg.replace(chunk_frames=2), params,
                           device="cpu").stabilize_clip(clips[0])
    np.testing.assert_array_equal(whole, halves)
    seq = _seq(2, n=5)
    with torch.no_grad():
        one = motion_cnn.encode_frames(model, seq)
        calls = grouped.in_groups(
            lambda f: motion_cnn.encode_frames(model, f), seq, 2,
            grouped=True)
    assert isinstance(calls, tuple) and len(calls) == 5
    for a, b in zip(one, calls):
        assert torch.equal(a, b)


class _Reader:
    def __init__(self, frames):
        self.frames, self.pos = frames, 0

    def read_batch(self, n):
        out = self.frames[self.pos:self.pos + n]
        self.pos += len(out)
        return out


class _Writer:
    def __init__(self):
        self.chunks = []

    def write_batch(self, frames):
        self.chunks.append(np.array(frames))


def _surface(name, cfg, params, frames):
    """``frames`` through one of the port's surfaces."""
    if name == "stream":
        w = _Writer()
        st.Stabilizer(cfg, params, device="cpu").stabilize_stream(
            _Reader(frames), w)
        return np.concatenate(w.chunks)
    if name == "overlapped":
        from dvsg_tpu_torch.pipeline.overlap import \
            stabilize_stream_overlapped
        w = _Writer()
        stabilize_stream_overlapped(
            st.Stabilizer(cfg, params, device="cpu"), _Reader(frames), w)
        return np.concatenate(w.chunks)
    if name == "online":
        from dvsg_tpu_torch.pipeline.online import OnlineStabilizer
        online = OnlineStabilizer(cfg, params, device="cpu")
        out = [f for frame in frames for f in online.push(frame)]
        return np.stack(out + online.flush())
    if name == "batch":
        from dvsg_tpu_torch.pipeline.batching import BatchStabilizer
        engine = BatchStabilizer(cfg, params, device="cpu")
        try:
            return engine.stabilize_clip(frames)
        finally:
            engine.close()
    raise ValueError(name)


@pytest.mark.parametrize("name", ["stream", "overlapped", "online", "batch"])
def test_every_stream_surface_gives_the_clips_bytes(name):
    _, params = _model(1)
    cfg = StabilizeConfig(model=MCFG, chunk_frames=4)
    frames = _clip(6, key=8, h=32, w=40)
    want = st.Stabilizer(cfg, params, device="cpu").stabilize_clip(frames)
    np.testing.assert_array_equal(_surface(name, cfg, params, frames), want)


def test_a_data_parallel_step_in_one_process_is_the_plain_step():
    from dvsg_tpu_torch.parallel import dp
    tcfg = TrainConfig(model=MCFG, batch_size=1, learning_rate=1e-3,
                       warmup_steps=1, steps=4)
    params = pwc.init(SMALL, 0)
    plain = loop.build_state(tcfg, params, "cpu", step=1)
    loop.train_step(plain, loop.step_generator(0, 1), tcfg)
    one = loop.build_state(tcfg, params, "cpu", step=1)
    step_fn, shard = dp.make_dp_train_step(
        tcfg, mesh_lib.make_mesh(device="cpu"))
    step_fn(one, shard(loop.step_generator(0, 1)))
    for k, v in one.params.items():
        torch.testing.assert_close(v, plain.params[k], rtol=0, atol=1e-7)


def test_eval_reports_the_arch():
    from dvsg_tpu_torch.train import eval as eval_lib
    _, params = _model(1)
    stab = st.Stabilizer(StabilizeConfig(model=MCFG, chunk_frames=4),
                         params, device="cpu")
    report = eval_lib.evaluate_synthetic(
        stab, torch.Generator().manual_seed(0), 8, 32, 40)
    assert all(np.isfinite(v) for v in report.values())


def test_in_groups_keeps_a_tuple_in_fixed_size_calls():
    sizes = []

    def fn(x):
        sizes.append(len(x[0]))
        return (x[0] * 2, x[1][:, :1])

    x = (torch.arange(10.0)[:, None], torch.arange(20.0).reshape(10, 2))
    out = grouped.in_groups(fn, x, 4, grouped=True)
    assert sizes == [4, 4, 4]
    assert torch.equal(out[0], x[0] * 2) and torch.equal(out[1], x[1][:, :1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_corr_archs_volume_is_unchanged_by_the_scale_argument(dtype):
    gen = torch.Generator().manual_seed(7)
    ref = torch.randn(2, 24, 8, 8, generator=gen).to(dtype)
    other = torch.randn(2, 3, 24, 8, 8, generator=gen).to(dtype)
    got = motion_cnn.correlation_volume(ref, other, 3)
    assert torch.equal(got, motion_cnn.correlation_volume(
        ref, other, 3, 24.0 ** -0.5))
    # the formula as it stood before the argument, in float32
    pad = torch.nn.functional.pad(other.float(), (3, 3, 3, 3))
    vols = [(ref.float()[:, None] * pad[..., dy:dy + 8, dx:dx + 8]).sum(2)
            for dy in range(7) for dx in range(7)]
    if dtype == torch.float32:
        assert torch.equal(got, torch.stack(vols, 2) * 24.0 ** -0.5)


def test_the_counters_count_pyramids_and_pairs(train_batch):
    model, _ = _model(0)
    seq, t, n = _seq(0), 4, MCFG.window
    frames0, pairs0 = motion_cnn.PWC_FRAMES, motion_cnn.PWC_PAIRS
    _port_offsets(model, seq, t)
    assert motion_cnn.PWC_FRAMES - frames0 == t + n - 1
    assert motion_cnn.PWC_PAIRS - pairs0 == t * (n - 1)
    tcfg, batch = train_batch
    frames0, pairs0 = motion_cnn.PWC_FRAMES, motion_cnn.PWC_PAIRS
    with torch.no_grad():
        loop.loss_from_batch(model, batch, tcfg)
    b, clip_len = batch[0].shape[:2]
    s = batch[1].shape[1]
    assert motion_cnn.PWC_FRAMES - frames0 == b * clip_len
    assert motion_cnn.PWC_PAIRS - pairs0 == b * s * (n - 1)


def test_the_published_widths_and_parameter_count():
    model = motion_cnn.MotionEstimator(model_config_from_dict(
        dict(SMALL, model_size=[256, 256], grid_size=[16, 16], window=5)))
    sd = model.state_dict()
    assert sum(v.numel() for k, v in sd.items()
               if not k.startswith("head_")) == 9_374_274
    assert sum(v.numel() for v in sd.values()) == 9_644_100
    assert {k: tuple(v.shape) for k, v in sd.items()} == pwc.shapes(
        dict(SMALL, window=5))
    assert tuple(sd["encoder.conv6aa.weight"].shape) == (196, 128, 3, 3)
    assert tuple(sd["upfeat3.weight"].shape) == (81 + 64 + 4 + 448, 2, 4, 4)
    assert model.dc_conv5.dilation == (16, 16)


def test_a_pwc_checkpoint_round_trips_and_stabilizes(tmp_path):
    _, params = _model(1)
    path = str(tmp_path / "pwc.npz")
    ckpt.export_npz(path, params, MCFG)
    loaded, cfg = ckpt.load_npz(path)
    assert cfg == MCFG and loaded.keys() == params.keys()
    for k in params:
        assert torch.equal(loaded[k], params[k]), k
    frames = _clip(4, h=32, w=40)
    with video_io.VideoWriter(str(tmp_path / "in"), 40, 32) as w:
        w.write_batch(frames)
    assert cli.main(["stabilize", "--input", str(tmp_path / "in"),
                     "--output", str(tmp_path / "out"), "--checkpoint",
                     path, "--chunk-frames", "4", "--platform", "cpu"]) == 0
    with video_io.VideoReader(str(tmp_path / "out")) as r:
        out = r.read_batch(100)
    np.testing.assert_array_equal(out, st.Stabilizer(
        StabilizeConfig(model=MCFG, chunk_frames=4), params,
        device="cpu").stabilize_clip(frames))


@pytest.mark.parametrize("kw,match", [
    (dict(dtype="bfloat16"), "pwc.*float32"),
    (dict(model_size=(96, 96), grid_size=(6, 6)), "pwc.*64"),
    (dict(grid_size=(8, 8)), "pwc.*model_size / 16"),
])
def test_configurations_the_arch_cannot_run_are_refused(kw, match):
    with pytest.raises(ValueError, match=match):
        dataclasses.replace(MCFG, **kw)


def test_an_exported_chunk_program_runs_the_arch(tmp_path):
    """The chunk step exported for the CPU gives the live step's bytes
    (radius 1 keeps the trace short); the export for the card from a
    PyTorch without CUDA is refused by name."""
    cfg = StabilizeConfig(model=dataclasses.replace(MCFG, corr_radius=1),
                          chunk_frames=4)
    params = pwc.init(dataclasses.asdict(cfg.model), 0)
    path = str(tmp_path / "pwc.dvsgt")
    export_lib.save_exported(export_lib.export_chunk_program(
        cfg, params, 32, 40, device="cpu"), path, cfg)
    clip = _clip(6, h=32, w=40)
    np.testing.assert_array_equal(
        export_lib.load_exported(path).stabilize_clip(clip),
        st.Stabilizer(cfg, params, device="cpu").stabilize_clip(clip))
    if not torch.backends.cuda.is_built():
        with pytest.raises(ValueError, match="pwc"):
            export_lib.export_chunk_program(cfg, params, 32, 40,
                                            for_device="cuda")


def test_tensor_parallelism_refuses_the_arch():
    model, _ = _model(0)
    with pytest.raises(ValueError, match="pwc"):
        tp.tp_model(model, mesh_lib.make_mesh(
            (1, 1), axis_names=("data", "model"), device="cpu"))


def test_a_training_step_moves_every_parameter(train_batch):
    tcfg = TrainConfig(model=MCFG, batch_size=1, learning_rate=1e-3,
                       warmup_steps=1, steps=4)
    state = loop.build_state(tcfg, pwc.init(SMALL, 0), device="cpu",
                             step=1)
    before = {k: v.clone() for k, v in state.params.items()}
    aux = loop.train_step(state, loop.step_generator(0, 1), tcfg)
    assert np.isfinite(float(aux["total"]))
    assert all(not torch.equal(before[k], v)
               for k, v in state.params.items() if k.endswith("weight"))


def test_init_params_draws_pwc_net_as_nvlabs_does():
    params = motion_cnn.init_params(MCFG, torch.Generator().manual_seed(0))
    w = params["conv2_0.weight"]                  # fan_in 117 * 9
    assert float(w.std()) == pytest.approx((2.0 / (117 * 9)) ** 0.5,
                                           rel=0.05)
    assert float(params["upfeat3.weight"].std()) == pytest.approx(
        (2.0 / 32) ** 0.5, rel=0.1)               # PyTorch's fan_in: 2 * 16
    assert not params["head_out.weight"].any()
    assert not any(v.any() for k, v in params.items() if k.endswith("bias"))


def _spans_of_one_pass():
    from torch.profiler import ProfilerActivity, profile
    model, _ = _model(0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _port_offsets(model, _seq(0, n=3), 1)
    return list(prof.profiler.kineto_results.events())


def test_without_a_profiler_the_spans_are_no_ops():
    for name in ("pwc_corr", "pwc_warp"):
        assert metrics.span(name) is metrics._NO_SPAN


def test_under_a_profiler_each_volume_and_warp_is_a_span():
    events = _spans_of_one_pass()
    for name, count in (("dvsg.pwc_corr", 5), ("dvsg.pwc_warp", 4)):
        found = [e for e in events if e.name() == name]
        assert len(found) == count, name
        assert all(e.device_type() == torch.autograd.DeviceType.CPU
                   and not e.is_user_annotation() for e in found)


def test_pwc_work_matches_the_counter_on_the_port_and_the_reference():
    model, params = _model(0)
    frames = torch.randint(0, 256, (2, 24, 40, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(4))
    want = _pwc_work.chunk_flops(SMALL, 2, 24, 40)
    with FlopCounterMode(display=False) as fc:
        stream_pwc.chunk(params, SMALL, frames, None)
    assert fc.get_total_flops() == want
    # the port's model over the chunk's 2 + 2 frames and 2 windows
    with FlopCounterMode(display=False) as fc:
        _port_offsets(model, _seq(0, n=4), 2)
    assert fc.get_total_flops() == (_pwc_work.encoder_flops(SMALL, 4)
                                    + _pwc_work.decoder_flops(SMALL, 4)
                                    + _pwc_work.head_flops(SMALL, 2))


def test_pwc_work_at_the_cell():
    model = dict(SMALL, model_size=[256, 256], grid_size=[16, 16], window=5)
    assert _pwc_work.encoder_flops(model, 1) == 737_141_760
    assert _pwc_work.decoder_flops(model, 1) == 22_559_701_824
    # 1.49 TFLOP a 720p chunk, 97 % of it the decoder's 64 passes
    total = _pwc_work.chunk_flops(model, 16, 720, 1280)
    assert total / 1e12 == pytest.approx(1.4924, abs=1e-4)
    assert _pwc_work.decoder_flops(model, 64) / total > 0.96
    # the volumes' and warps' function bytes of a chunk's 64 pairs
    assert _pwc_work.corr_bytes(model, 64) == 232_181_760
    assert _pwc_work.warp_bytes(model, 64) == 120_225_792


CELL = dict(SMALL, model_size=[256, 256], grid_size=[16, 16], window=5)


def _run(trace, chunks=2):
    spec = harness.Spec(cell={}, config={"model": CELL}, traffic={},
                        limits={}, end_to_end=[], per_layer=[])
    return harness.Run(spec=spec, rank=0, world=1, setup_s=0.0,
                       window_s=1e-3,
                       work={"chunks": chunks, "chunk_frames": 16,
                             "height": 720, "width": 1280,
                             "frames": 16 * chunks},
                       stamps={}, stages={}, checks={}, attempted=chunks,
                       failed=0, memory_peak_bytes=0, trace=trace)


def _pwc_trace():
    """A 1 ms window: a corr span 100-300 us launching 40 + 20 us of
    kernels, a warp span 400-500 us launching 10 us, a conv outside both
    and a corr span on a second thread launching 30 us."""
    return tracing.Trace([
        _Ev("dvsg.pwc_corr", "cpu_op", 100_000, 200_000, cid=1),
        _Ev("aten::mul", "cpu_op", 110_000, 10_000, cid=2),
        _Ev("mul_kernel", "kernel", 150_000, 40_000, link=2),
        _Ev("aten::sum", "cpu_op", 130_000, 10_000, cid=3),
        _Ev("sum_kernel", "kernel", 200_000, 20_000, link=3),
        _Ev("dvsg.pwc_warp", "cpu_op", 400_000, 100_000, cid=4),
        _Ev("aten::grid_sampler_2d", "cpu_op", 410_000, 10_000, cid=5),
        _Ev("grid_kernel", "kernel", 420_000, 10_000, link=5),
        _Ev("aten::convolution", "cpu_op", 600_000, 10_000, cid=6),
        _Ev("conv_kernel", "kernel", 610_000, 200_000, link=6),
        _Ev("dvsg.pwc_corr", "cpu_op", 850_000, 100_000, cid=7, tid=2),
        _Ev("aten::mul", "cpu_op", 860_000, 10_000, cid=8, tid=2),
        _Ev("mul_kernel", "kernel", 870_000, 30_000, link=8),
    ], 0, 1_000_000)


def _read(name, run):
    return harness.load_module("metrics", name).read(run)


def test_the_roofline_metrics_read_the_kernels_inside_their_spans():
    run = _run(_pwc_trace())
    peak = _work.PEAKS["hbm_bytes_per_s"]
    pairs = 2 * 16 * 4
    assert _read("pwc_corr_roofline", run) == pytest.approx(
        100.0 * _pwc_work.corr_bytes(CELL, pairs) / peak / 90e-6)
    assert _read("pwc_warp_roofline", run) == pytest.approx(
        100.0 * _pwc_work.warp_bytes(CELL, pairs) / peak / 10e-6)


def test_the_mfu_counts_the_pwc_chunk():
    run = _run(_pwc_trace())
    assert _read("mfu_pct.stream_pwc", run) == pytest.approx(
        100.0 * 2 * _pwc_work.chunk_flops(CELL, 16, 720, 1280) / 1e-3
        / _work.PEAKS["flops_f32"])


@pytest.mark.parametrize("name", ["pwc_corr_roofline", "pwc_warp_roofline",
                                  "mfu_pct.stream_pwc"])
def test_an_untraced_run_or_a_program_without_spans_reads_nothing(name):
    assert _read(name, _run(None)) is None
    no_spans = tracing.Trace([
        _Ev("aten::mul", "cpu_op", 0, 20_000, cid=1),
        _Ev("mul_kernel", "kernel", 10_000, 100_000, link=1)], 0, 1_000_000)
    if name.endswith("_roofline"):
        assert _read(name, _run(no_spans)) is None
