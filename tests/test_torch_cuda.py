"""The port's CUDA kernels on the card, held against their plain versions.

Marked ``cuda``: they skip on a machine without a CUDA card. On the card
they run without the JAX side of the suite (no jax is needed there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from dvsg_tpu_torch.ops import warp_bilinear, warp_wide

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("shape,grid,amp,crop", [
    ((2, 37, 150, 3), (6, 8), 0.2, 0.0),          # W % 4 != 0: general
    ((2, 37, 150, 3), (6, 8), 0.2, 0.1),
    ((3, 97, 131, 3), (16, 16), 1.5, 0.0),
    ((3, 64, 96, 1), (6, 16), 1.5, 0.0),          # C != 3: general
    ((1, 33, 260, 4), (6, 5), 0.5, 0.25),
    ((2, 37, 152, 3), (6, 8), 0.2, 0.0),          # RGB, W % 4 == 0: packed
    ((2, 37, 152, 3), (6, 8), 0.2, 0.1),
    ((3, 64, 96, 3), (8, 8), 1.5, 0.0),
    ((1, 33, 260, 3), (32, 32), 0.5, 0.25),
    ((2, 5, 4, 3), (3, 2), 1.5, 0.0),             # one pixel group a row
])
def test_warp_u8_offsets_kernels_match_plain(dev, shape, grid, amp, crop):
    """The kernel the wrapper picks for the shape, and on the packed
    kernel's shapes the general-shape kernel too, within 1 LSB of plain."""
    rng = np.random.default_rng(7)
    frames = torch.from_numpy(
        rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
    offs = torch.from_numpy(rng.uniform(
        -amp, amp, (shape[0], *grid, 2)).astype(np.float32)).to(dev)
    packed = warp_wide.takes_packed_kernel(shape)
    before = warp_wide.LAUNCHES, warp_wide.LAUNCHES_PACKED
    outs = [warp_wide.warp_u8_offsets(frames, offs, crop)]
    assert warp_wide.LAUNCHES == before[0] + 1
    assert warp_wide.LAUNCHES_PACKED == before[1] + packed
    if packed:
        outs.append(warp_wide._launch(
            frames, warp_wide.offset_rows(offs, shape[1]), crop,
            packed=False))
    want = warp_wide.warp_u8_offsets_plain(frames, offs, crop)
    torch.cuda.synchronize()
    for got in outs:
        diff = (got.to(torch.int16) - want.to(torch.int16)).abs()
        assert got.shape == frames.shape and got.dtype == torch.uint8
        assert int(diff.max()) <= 1


def test_warp_u8_offsets_packed_kernel_refuses_other_shapes(dev):
    """Forced onto a shape it does not take, the packed kernel's launcher
    refuses and the wrapper raises; a view off the word boundary is moved,
    not refused."""
    rng = np.random.default_rng(6)
    flat = torch.from_numpy(rng.integers(
        0, 256, 2 * 8 * 12 * 3 + 1, dtype=np.uint8)).to(dev)
    frames = flat[1:].view(2, 8, 12, 3)            # data_ptr % 4 == 1
    offs = torch.zeros((2, 4, 4, 2), device=dev)
    assert torch.equal(warp_wide.warp_u8_offsets(frames, offs), frames)
    rows = warp_wide.offset_rows(offs, 8)
    with pytest.raises(RuntimeError, match="launch failed"):
        warp_wide._launch(frames[:, :, :10].contiguous(), rows, 0.0,
                          packed=True)


def test_warp_u8_offsets_noncontiguous_frames(dev):
    rng = np.random.default_rng(8)
    base = torch.from_numpy(
        rng.integers(0, 256, (2, 40, 304, 3), dtype=np.uint8)).to(dev)
    frames = base[:, :, ::2]                       # strided view, W = 152
    offs = torch.zeros((2, 4, 4, 2), device=dev)
    got = warp_wide.warp_u8_offsets(frames, offs)
    torch.cuda.synchronize()
    # Identity offsets: the warp reproduces the frames exactly.
    assert torch.equal(got, frames.contiguous())


# --- the dense-grid warps ------------------------------------------------------

def _grids(rng, b, ho, wo, spill, dev):
    """Smooth grids around the identity, scaled by ``spill`` (> 1 leaves
    the frame on both sides)."""
    ys, xs = np.meshgrid(np.linspace(-1, 1, ho), np.linspace(-1, 1, wo),
                         indexing="ij")
    base = np.stack([xs, ys], -1)[None]
    g = (base + rng.uniform(-0.2, 0.2, (b, ho, wo, 2))) * spill
    return torch.from_numpy(g.astype(np.float32)).to(dev)


SHAPES = [((2, 37, 150, 3), (37, 150), 1.0),
          ((2, 37, 150, 3), (23, 61), 1.3),       # output size != input's
          ((3, 64, 96, 1), (64, 96), 1.0),
          ((1, 33, 257, 4), (50, 40), 2.0)]


@pytest.mark.parametrize("shape,out_hw,spill", SHAPES)
def test_warp_f32_kernel_matches_plain(dev, shape, out_hw, spill):
    rng = np.random.default_rng(9)
    frames = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(dev)
    grids = _grids(rng, shape[0], *out_hw, spill, dev)
    before = warp_bilinear.LAUNCHES_WARP
    got = warp_bilinear.bilinear_warp_batch(frames, grids)
    assert warp_bilinear.LAUNCHES_WARP == before + 1
    want = warp_bilinear.bilinear_warp_batch_plain(frames, grids)
    torch.cuda.synchronize()
    assert got.shape == (shape[0], *out_hw, shape[3])
    assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.parametrize("shape,out_hw,spill", SHAPES)
def test_warp_f32_diff_kernels_match_plain(dev, shape, out_hw, spill):
    """Values and the grid cotangent of the differentiable warp: the
    forward kernel (values only) and the backward kernel (cotangent,
    frames, grids) against their plain versions, called directly and
    through autograd, which keeps no derivative image."""
    rng = np.random.default_rng(10)
    frames = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(dev)
    grids = _grids(rng, shape[0], *out_hw, spill, dev).requires_grad_()
    cot = torch.from_numpy(rng.standard_normal(
        (shape[0], *out_hw, shape[3])).astype(np.float32)).to(dev)
    fwd, bwd = (warp_bilinear.LAUNCHES_DIFF_FWD,
                warp_bilinear.LAUNCHES_DIFF_BWD)
    out = warp_bilinear.bilinear_warp_batch_grids_diff(frames, grids)
    kept = sorted(tuple(t.shape) for t in out.grad_fn.saved_tensors)
    assert kept == sorted([tuple(frames.shape), tuple(grids.shape)])
    out.backward(cot)
    assert warp_bilinear.LAUNCHES_DIFF_FWD == fwd + 1
    assert warp_bilinear.LAUNCHES_DIFF_BWD == bwd + 1
    g = grids.detach()
    o_k = warp_bilinear.warp_diff_forward(frames, g)
    o_p = warp_bilinear.bilinear_warp_batch_plain(frames, g)
    d_k = warp_bilinear.warp_diff_backward(cot, frames, g)
    want = warp_bilinear.warp_diff_grid_grad_plain(cot, frames, g)
    assert warp_bilinear.LAUNCHES_DIFF_FWD == fwd + 2
    assert warp_bilinear.LAUNCHES_DIFF_BWD == bwd + 2
    torch.cuda.synchronize()
    assert float((out.detach() - o_p).abs().max()) <= 1e-5
    assert float((o_k - o_p).abs().max()) <= 1e-5
    scale = 0.5 * (max(shape[1], shape[2]) - 1)
    assert float((grids.grad - want).abs().max()) <= 1e-5 * scale * shape[3]
    assert float((d_k - want).abs().max()) <= 1e-5 * scale * shape[3]
    with pytest.raises(ValueError, match="one warp"):
        warp_bilinear.warp_diff_backward(cot[:, :-1], frames, g)


def test_warp_f32_diff_frames_get_no_gradient(dev):
    rng = np.random.default_rng(11)
    frames = torch.from_numpy(
        rng.random((1, 16, 24, 3), dtype=np.float32)).to(dev).requires_grad_()
    grids = _grids(rng, 1, 16, 24, 1.0, dev).requires_grad_()
    warp_bilinear.bilinear_warp_batch_grids_diff(frames, grids).sum(
        ).backward()
    assert frames.grad is None and grids.grad is not None


@pytest.mark.parametrize("shape,out_hw,spill", SHAPES)
def test_warp_u8_batch_kernel_matches_plain(dev, shape, out_hw, spill):
    rng = np.random.default_rng(12)
    frames = torch.from_numpy(
        rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
    grids = _grids(rng, shape[0], *out_hw, spill, dev)
    before = warp_wide.LAUNCHES_BATCH, warp_wide.LAUNCHES_BATCH_PACKED
    got = warp_wide.warp_u8_batch(frames, grids)
    assert warp_wide.LAUNCHES_BATCH == before[0] + 1
    assert warp_wide.LAUNCHES_BATCH_PACKED == before[1]    # general shapes
    want = warp_wide.warp_u8_batch_plain(frames, grids)
    torch.cuda.synchronize()
    assert got.dtype == torch.uint8
    assert got.shape == (shape[0], *out_hw, shape[3])
    diff = (got.to(torch.int16) - want.to(torch.int16)).abs()
    assert int(diff.max()) <= 1


# The packed dense-grid kernel's shapes: RGB, W and Wo multiples of four.
PACKED_SHAPES = [((2, 37, 152, 3), (37, 152), 1.0),
                 ((2, 40, 152, 3), (36, 100), 1.4),  # output size != input's
                 ((3, 64, 96, 3), (64, 96), 2.0),
                 ((1, 5, 4, 3), (3, 4), 1.5)]        # one pixel group a row


@pytest.mark.parametrize("shape,out_hw,spill", PACKED_SHAPES)
def test_warp_u8_batch_packed_kernel_equals_general(dev, shape, out_hw,
                                                    spill):
    """On its shapes the wrapper takes the packed kernel, which gives the
    general-shape kernel's bytes; both within 1 LSB of plain."""
    rng = np.random.default_rng(13)
    frames = torch.from_numpy(
        rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
    grids = _grids(rng, shape[0], *out_hw, spill, dev)
    assert warp_wide.takes_packed_batch_kernel(shape, grids.shape)
    before = warp_wide.LAUNCHES_BATCH, warp_wide.LAUNCHES_BATCH_PACKED
    packed = warp_wide.warp_u8_batch(frames, grids)
    assert (warp_wide.LAUNCHES_BATCH, warp_wide.LAUNCHES_BATCH_PACKED) \
        == (before[0] + 1, before[1] + 1)
    general = warp_wide._launch_batch(frames, grids, packed=False)
    want = warp_wide.warp_u8_batch_plain(frames, grids)
    torch.cuda.synchronize()
    assert packed.shape == (shape[0], *out_hw, 3)
    assert torch.equal(packed, general)
    for got in (packed, general):
        diff = (got.to(torch.int16) - want.to(torch.int16)).abs()
        assert int(diff.max()) <= 1


def test_warp_u8_batch_packed_kernel_refuses_other_shapes(dev):
    """Forced onto a shape it does not take, the packed kernel's launcher
    refuses and the wrapper raises."""
    rng = np.random.default_rng(14)
    for (b, h, w, c), (ho, wo) in (((2, 8, 10, 3), (8, 12)),   # W % 4
                                   ((2, 8, 12, 3), (8, 10)),   # Wo % 4
                                   ((2, 8, 12, 1), (8, 12)),   # C
                                   ((2, 8, 12, 4), (8, 12))):
        frames = torch.zeros((b, h, w, c), dtype=torch.uint8, device=dev)
        grids = _grids(rng, b, ho, wo, 1.0, dev)
        assert not warp_wide.takes_packed_batch_kernel(frames.shape,
                                                       grids.shape)
        with pytest.raises(RuntimeError, match="launch failed"):
            warp_wide._launch_batch(frames, grids, packed=True)


def test_warp_u8_batch_packed_kernel_on_unaligned_views(dev):
    """Frames off the word boundary and grids off the 16-byte boundary are
    moved, not refused, and give the right bytes; the identity grid gives
    the frames back exactly."""
    rng = np.random.default_rng(15)
    shape, (ho, wo) = (2, 24, 44, 3), (20, 36)
    flat = torch.from_numpy(rng.integers(
        0, 256, int(np.prod(shape)) + 1, dtype=np.uint8)).to(dev)
    frames = flat[1:].view(shape)                   # data_ptr % 4 == 1
    g = _grids(rng, shape[0], ho, wo, 1.3, dev)
    gflat = torch.empty(g.numel() + 1, device=dev)
    gflat[1:] = g.reshape(-1)
    grids = gflat[1:].view(g.shape)                 # data_ptr % 16 == 4
    assert frames.data_ptr() % 4 and grids.data_ptr() % 16
    before = warp_wide.LAUNCHES_BATCH_PACKED
    got = warp_wide.warp_u8_batch(frames, grids)
    assert warp_wide.LAUNCHES_BATCH_PACKED == before + 1
    general = warp_wide._launch_batch(frames.contiguous().clone(),
                                      g.contiguous(), packed=False)
    want = warp_wide.warp_u8_batch_plain(frames, grids)
    ys, xs = torch.meshgrid(torch.linspace(-1, 1, shape[1], device=dev),
                            torch.linspace(-1, 1, shape[2], device=dev),
                            indexing="ij")
    ident = torch.stack([xs, ys], -1).expand(shape[0], -1, -1, -1)
    same = warp_wide.warp_u8_batch(frames, ident)
    torch.cuda.synchronize()
    assert torch.equal(got, general)
    assert int((got.to(torch.int16) - want.to(torch.int16)).abs().max()) <= 1
    assert torch.equal(same, frames)


def test_train_step_on_the_card_matches_the_cpu(dev):
    """One small train step through the kernels on the card against the
    same step through the plain versions on the CPU."""
    from dvsg_tpu_torch.config import ModelConfig, TrainConfig
    from dvsg_tpu_torch.models import motion_cnn
    from dvsg_tpu_torch.train import loop
    mcfg = ModelConfig(window=3, model_size=(32, 32), grid_size=(8, 8),
                       base_features=8, blocks_per_level=1)
    cfg = TrainConfig(model=mcfg, batch_size=2, steps=4, warmup_steps=1)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    params = motion_cnn.init_params(mcfg, gen)
    params["head_out.weight"] = 0.05 * torch.randn(
        params["head_out.weight"].shape, generator=gen)
    totals = {}
    for device in ("cpu", "cuda"):
        state = loop.build_state(cfg, params, device=device)
        total, _ = loop.loss_fn(state.model, loop.step_generator(0, 0), cfg)
        total.backward()
        totals[device] = (float(total.detach()), {
            n: p.grad.cpu() for n, p in state.model.named_parameters()})
    assert totals["cuda"][0] == pytest.approx(totals["cpu"][0], rel=1e-4)
    for n, g in totals["cpu"][1].items():
        scale = float(g.abs().max())
        assert float((totals["cuda"][1][n] - g).abs().max()) <= 1e-3 * scale


# --- path smoothing, online push and the overlapped stream on the card ------

def _smooth_setup(**kw):
    from dvsg_tpu_torch.config import ModelConfig, StabilizeConfig
    from dvsg_tpu_torch.models import motion_cnn
    from dvsg_tpu_torch.train import synthetic
    mcfg = ModelConfig(window=3, model_size=(32, 32), grid_size=(8, 8),
                       base_features=8, blocks_per_level=1)
    gen = torch.Generator().manual_seed(0)
    params = motion_cnn.init_params(mcfg, gen)
    params["head_out.weight"] = 0.05 * torch.randn(
        params["head_out.weight"].shape, generator=gen)
    frames = synthetic.synthetic_clip_u8(
        torch.Generator().manual_seed(3), 14, 40, 48)[0].numpy()
    cfg = StabilizeConfig(model=mcfg, chunk_frames=4, path_smooth=8, **kw)
    return cfg, params, frames


@pytest.mark.parametrize("lag", [0, 4])
def test_smoothed_chunk_steps_on_the_card_match_the_cpu(dev, lag):
    """The smoothed and lag clips on the card within 1 LSB of the CPU
    path, each chunk through the packed offsets kernel; one chunk step
    again under sync debug mode "error": no host synchronization."""
    from dvsg_tpu_torch.pipeline import stabilize as stab_lib
    cfg, params, frames = _smooth_setup(path_smooth_lag=lag)
    cpu = stab_lib.Stabilizer(cfg, params, device="cpu")
    card = stab_lib.Stabilizer(cfg, params, device=dev)
    before = warp_wide.LAUNCHES_PACKED
    got = card.stabilize_clip(frames)
    chunks = -(-(len(frames) + lag) // cfg.chunk_frames)
    assert warp_wide.LAUNCHES_PACKED == before + chunks
    assert np.abs(got.astype(int) - cpu.stabilize_clip(frames)).max() <= 1
    with torch.inference_mode():
        chunk = stab_lib.put_frames(frames[:4], dev)
        halo = card._initial_halo(frames[0])
        step = stab_lib.ChunkStep(cfg, card.model)
        step(chunk, halo)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            step(chunk, halo)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()


def test_online_push_on_the_card_equals_clip(dev):
    from dvsg_tpu_torch.pipeline.online import OnlineStabilizer
    from dvsg_tpu_torch.pipeline.stabilize import Stabilizer
    cfg, params, frames = _smooth_setup()
    want = Stabilizer(cfg, params, device=dev).stabilize_clip(frames)
    online = OnlineStabilizer(cfg, params, device=dev)
    got = [f for frame in frames for f in online.push(frame)]
    got += online.flush()
    np.testing.assert_array_equal(np.stack(got), want)


class _Reader:
    def __init__(self, frames):
        self.frames, self.pos = frames, 0
        self.height, self.width = frames.shape[1:3]

    def read_batch(self, n):
        out = self.frames[self.pos:self.pos + n]
        self.pos += len(out)
        return out


class _Writer:
    def __init__(self):
        self.chunks = []

    def write_batch(self, frames):
        self.chunks.append(np.array(frames))


@pytest.mark.parametrize("depth", [1, 3])
def test_overlapped_stream_on_the_card_equals_sync(dev, depth):
    """Pinned staging rings, the copy stream and its events: the
    overlapped stream gives the sync stream's bytes, run after run."""
    from dvsg_tpu_torch.pipeline.overlap import stabilize_stream_overlapped
    from dvsg_tpu_torch.pipeline.stabilize import Stabilizer
    cfg, params, frames = _smooth_setup()
    cfg = cfg.replace(queue_depth=depth)
    stab = Stabilizer(cfg, params, device=dev)
    want = stab.stabilize_clip(frames)
    for _ in range(3):
        w = _Writer()
        assert stabilize_stream_overlapped(stab, _Reader(frames), w) \
            == len(frames)
        np.testing.assert_array_equal(np.concatenate(w.chunks), want)


# --- batch and serve on the card ----------------------------------------------

def _fast_setup(n_clips=8, frames=24, h=96, w=160):
    import os
    from dvsg_tpu_torch.train import synthetic
    from dvsg_tpu_torch.utils.checkpoint import load_npz
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    params, mcfg = load_npz(os.path.join(root, "checkpoints",
                                         "flagship_fast.npz"))
    clips = np.stack([synthetic.synthetic_clip_u8(
        torch.Generator().manual_seed(20 + i), frames, h, w)[0].numpy()
        for i in range(n_clips)])
    return params, mcfg, clips


BATCH_MODES = {"plain": {}, "causal": dict(path_smooth=32),
               "lag": dict(path_smooth=32, path_smooth_lag=8)}


@pytest.mark.parametrize("mode", list(BATCH_MODES))
def test_batch_size_invariance_on_the_card(dev, mode):
    """One clip in batches of 1, 2, 4 and 8 gives the single-clip bytes,
    with one launch of the offsets kernel per batched chunk."""
    from dvsg_tpu_torch.config import StabilizeConfig
    from dvsg_tpu_torch.pipeline import stabilize as st
    params, mcfg, clips = _fast_setup()
    cfg = StabilizeConfig(model=mcfg, chunk_frames=8, **BATCH_MODES[mode])
    want = st.Stabilizer(cfg, params, device=dev).stabilize_clip(clips[0])
    model = st.build_model(mcfg, params, dev)
    lag = cfg.path_smooth_lag
    chunks = -(-(clips.shape[1] + lag) // cfg.chunk_frames)
    for b in (1, 2, 4, 8):
        before = warp_wide.LAUNCHES
        out = st.drive_chunked_batch(st.ChunkStep(cfg, model, batched=True),
                                     clips[:b])
        assert warp_wide.LAUNCHES == before + chunks
        np.testing.assert_array_equal(out[0], want, err_msg=f"B={b}")


@pytest.mark.parametrize("mode", list(BATCH_MODES))
def test_chunk_size_invariance_on_the_card(dev, mode):
    from dvsg_tpu_torch.config import StabilizeConfig
    from dvsg_tpu_torch.pipeline.stabilize import Stabilizer
    params, mcfg, clips = _fast_setup(n_clips=1, frames=40)
    outs = [Stabilizer(StabilizeConfig(model=mcfg, chunk_frames=t,
                                       **BATCH_MODES[mode]), params,
                       device=dev).stabilize_clip(clips[0])
            for t in (8, 16)]
    np.testing.assert_array_equal(outs[0], outs[1])


def test_engine_and_multi_on_the_card_equal_single(dev):
    """BatchStabilizer from concurrent threads and stabilize_multi on the
    card give each clip its single-clip bytes."""
    import concurrent.futures
    from dvsg_tpu_torch.config import StabilizeConfig
    from dvsg_tpu_torch.pipeline.batching import BatchStabilizer
    from dvsg_tpu_torch.pipeline.multiclip import stabilize_multi
    from dvsg_tpu_torch.pipeline.stabilize import Stabilizer
    params, mcfg, clips = _fast_setup(n_clips=3)
    lens = (24, 17, 9)
    cfg = StabilizeConfig(model=mcfg, chunk_frames=8, path_smooth=32)
    single = Stabilizer(cfg, params, device=dev)
    want = [single.stabilize_clip(c[:n]) for c, n in zip(clips, lens)]
    engine = BatchStabilizer(cfg, params, max_batch=3, window_s=5.0,
                             device=dev)
    try:
        with concurrent.futures.ThreadPoolExecutor(3) as ex:
            got = list(ex.map(engine.stabilize_clip,
                              [c[:n] for c, n in zip(clips, lens)]))
        assert engine.stats["max_group"] == 3
    finally:
        engine.close()
    writers = [_Writer() for _ in lens]
    res = stabilize_multi(cfg, params, [_Reader(c[:n]) for c, n in
                                        zip(clips, lens)],
                          writers, device=dev)
    assert res.ok
    for w_, g, w in zip(writers, got, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(np.concatenate(w_.chunks), w)


# --- the registered offsets op, export and a world of one over NCCL ---------

def test_registered_op_launches_the_kernel(dev):
    """torch.ops.dvsg_torch.warp_u8_offsets_rows on the card is one kernel
    launch, within 1 LSB of the plain version; an exported chunk step
    launches it once per chunk and equals the live step bytewise."""
    from dvsg_tpu_torch import export as export_lib
    from dvsg_tpu_torch.config import StabilizeConfig
    from dvsg_tpu_torch.pipeline import stabilize as st
    rng = np.random.default_rng(9)
    frames = torch.from_numpy(
        rng.integers(0, 256, (4, 48, 64, 3), dtype=np.uint8)).to(dev)
    offs = torch.from_numpy(rng.uniform(
        -0.2, 0.2, (4, 8, 8, 2)).astype(np.float32)).to(dev)
    rows = warp_wide.offset_rows(offs, 48)
    before = warp_wide.LAUNCHES
    got = torch.ops.dvsg_torch.warp_u8_offsets_rows(frames, rows, 0.05)
    assert warp_wide.LAUNCHES == before + 1
    want = warp_wide.warp_u8_offsets_plain(frames, offs, 0.05)
    torch.cuda.synchronize()
    assert int((got.to(torch.int16) - want.to(torch.int16)).abs().max()) <= 1

    cfg, params, clip = _smooth_setup()
    exp = export_lib.export_chunk_program(cfg, params, 40, 48, device=dev)
    assert any("dvsg_torch.warp_u8_offsets_rows" in str(n.target)
               for n in exp.program.graph.nodes)
    chunk = torch.from_numpy(clip[:4]).to(dev)
    model = st.build_model(cfg.model, params, dev)
    halo = st.initial_halo(cfg, clip[0], dev)
    state = torch.zeros(4, device=dev)
    with torch.inference_mode():
        live = st.stabilize_chunk_smooth_impl(cfg, model, chunk, halo, state)
        before = warp_wide.LAUNCHES
        out = exp.program.module()(chunk, halo, state)
        assert warp_wide.LAUNCHES == before + 1
    for a, b in zip(out, live):
        assert torch.equal(a, b)


def test_world_of_one_over_nccl(dev, tmp_path):
    """A one-rank NCCL group on the card: the DP train step equals
    train_step to the last bit, the sharded and temporal stabilizers equal
    the single-clip path bytewise."""
    import torch.distributed as dist
    from dvsg_tpu_torch.config import StabilizeConfig, TrainConfig
    from dvsg_tpu_torch.parallel import dp, dryrun
    from dvsg_tpu_torch.parallel import mesh as mesh_lib
    from dvsg_tpu_torch.parallel.temporal import TemporalShardedStabilizer
    from dvsg_tpu_torch.pipeline.stabilize import Stabilizer
    from dvsg_tpu_torch.train import loop
    dryrun.join_group(0, 1, str(tmp_path / "store"), "nccl")
    try:
        mesh = mesh_lib.make_mesh(device="cuda:0")
        assert mesh.backend == "nccl" and mesh.size == 1
        cfg, params, clip = _smooth_setup()
        tcfg = TrainConfig(model=cfg.model, batch_size=4, steps=4,
                           warmup_steps=1)
        one = loop.build_state(tcfg, params, dev)
        state = dp.replicate_state(loop.build_state(tcfg, params, dev), mesh)
        step_fn, shard_batch = dp.make_dp_train_step(tcfg, mesh)
        # cuDNN's default backward sums in a run-dependent order.
        torch.backends.cudnn.deterministic = True
        try:
            for step in range(2):
                want = loop.train_step(one, loop.step_generator(0, step),
                                       tcfg)
                got = step_fn(state, shard_batch(loop.step_generator(0,
                                                                     step)))
                assert float(got["total"]) == float(want["total"])
        finally:
            torch.backends.cudnn.deterministic = False
        for a, b in zip(one.params.values(), state.params.values()):
            assert torch.equal(a, b)
        for kw in ({}, dict(path_smooth_lag=2)):
            c = cfg.replace(**kw)
            out = dp.ShardedClipStabilizer(c, params, mesh).stabilize_clips(
                clip[None])
            np.testing.assert_array_equal(
                out[0], Stabilizer(c, params, device=dev).stabilize_clip(clip))
        out = TemporalShardedStabilizer(cfg, params, mesh).stabilize_clip(clip)
        np.testing.assert_array_equal(
            out, Stabilizer(cfg, params, device=dev).stabilize_clip(clip))
    finally:
        dist.destroy_process_group()


def test_two_nccl_ranks_on_two_cards(dev, tmp_path):
    """Two NCCL ranks, one a card, their current device left as the
    process started: each drives the card of its rank; the temporal ring
    exchange gives one process's frames bytewise (plain and causal); two
    runs of the same DP steps give the same bytes on both ranks, their
    losses within rtol 1e-5 of train_step; ``all_gather_object`` gathers
    every rank's object."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    import torch_ranks
    from dvsg_tpu_torch.config import TrainConfig
    from dvsg_tpu_torch.pipeline.stabilize import Stabilizer
    from dvsg_tpu_torch.train import loop
    cfg, params, clip = _smooth_setup()
    cfg = cfg.replace(path_smooth=0)
    tcfg = TrainConfig(model=cfg.model, batch_size=4, steps=4,
                       warmup_steps=1)
    ranks = torch_ranks.spawn("nccl", 2, tmp_path, dict(
        cfg=cfg, params=params, clip=clip, tcfg=tcfg, tparams=params,
        steps=3), backend="nccl")
    want = {m: Stabilizer(cfg.replace(**torch_ranks.MODES[m]), params,
                          device=dev).stabilize_clip(clip)
            for m in ("plain", "causal")}
    one = loop.build_state(tcfg, params, dev)
    losses = [float(loop.train_step(one, loop.step_generator(0, i), tcfg)
                    ["total"]) for i in range(3)]
    for r, got in enumerate(ranks):
        assert (got["device"], got["backend"]) == (f"cuda:{r}", "nccl")
        assert got["objects"] == [(0, "cuda:0"), (1, "cuda:1")]
        for m, frames in want.items():
            np.testing.assert_array_equal(got[m], frames)
        assert got["dp"][0] == got["dp"][1] == ranks[0]["dp"][0]
        np.testing.assert_allclose(got["dp"][0][0], losses, rtol=1e-5)


def test_artifact_exported_without_a_card_runs_on_the_card(dev, tmp_path):
    """A process that sees no card exports the chunk step for the card
    (plain and smoothed); loaded here, its frames equal the live path's
    bytewise, with one launch a chunk."""
    import os
    import subprocess
    import sys
    from dvsg_tpu_torch import export as export_lib
    from dvsg_tpu_torch.pipeline.stabilize import Stabilizer
    from dvsg_tpu_torch.utils import checkpoint as ckpt
    cfg, params, clip = _smooth_setup()
    npz = str(tmp_path / "m.npz")
    ckpt.export_npz(npz, params, cfg.model)
    for c in (cfg.replace(path_smooth=0), cfg):
        path = str(tmp_path / f"m{c.path_smooth}.dvsgt")
        code = ("import sys, torch; assert not torch.cuda.is_available(); "
                "from dvsg_tpu_torch.cli import main; "
                "sys.exit(main(sys.argv[1:]))")
        r = subprocess.run(
            [sys.executable, "-c", code, "export", "--checkpoint", npz,
             "--size", str(clip.shape[1]), str(clip.shape[2]),
             "--chunk-frames", str(c.chunk_frames), "--path-smooth",
             str(c.path_smooth), "--for-platform", "cuda", "--output",
             path], env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
            capture_output=True, text=True, timeout=600)
        assert r.returncode == 0, r.stderr[-3000:]
        loaded = export_lib.load_exported(path)
        assert loaded.device == dev
        before = warp_wide.LAUNCHES
        got = loaded.stabilize_clip(clip)
        torch.cuda.synchronize()
        assert warp_wide.LAUNCHES - before == -(-len(clip) // c.chunk_frames)
        np.testing.assert_array_equal(
            got, Stabilizer(c, params, device=dev).stabilize_clip(clip))


def test_tensor_parallel_on_the_card(dev, tmp_path):
    """Two gloo ranks sharing the card on a (1, 2) ("data", "model")
    mesh: offsets within 2e-5 of the unsharded model, a clip through the
    TP chunk step within 1 LSB of stabilize_clip."""
    import torch_ranks
    from dvsg_tpu_torch.models import motion_cnn
    from dvsg_tpu_torch.pipeline.stabilize import Stabilizer, build_model
    cfg, params, clip = _smooth_setup()
    cfg = cfg.replace(path_smooth=0)
    rng = np.random.default_rng(4)
    mh, mw = cfg.model.model_size
    windows = (rng.random((4, mh, mw, 3 * cfg.model.window), np.float32)
               - 0.5).astype(np.float32)
    ranks = torch_ranks.spawn("tp", 2, tmp_path, {
        "cfg": cfg, "params": params, "shapes": ((1, 2),),
        "windows": windows, "clip": clip, "clips": clip[None],
        "device": "cuda:0"})
    with torch.inference_mode():
        want = motion_cnn.predict_offsets(
            build_model(cfg.model, params, dev),
            torch.from_numpy(windows).to(dev)).cpu().numpy()
    frames = Stabilizer(cfg, params, device=dev).stabilize_clip(clip)
    for r in ranks:
        g = r["1x2"]
        np.testing.assert_allclose(g["offsets"], want, atol=2e-5)
        assert int(np.abs(g["clip"].astype(int)
                          - frames.astype(int)).max()) <= 1


# --- bf16 compute and the stacked arch ------------------------------------

def _variant(mcfg, variant: str, params):
    """(model config, weights) of a variant of the fast model: bf16 on
    the committed weights, or the stacked arch from a seeded init with a
    seeded head (an init's zero head_out would predict no motion)."""
    import dataclasses
    from dvsg_tpu_torch.models import motion_cnn
    if variant == "bf16":
        return dataclasses.replace(mcfg, dtype="bfloat16"), params
    cfg = dataclasses.replace(mcfg, arch="stacked",
                              dtype="bfloat16" if "bf16" in variant
                              else "float32")
    gen = torch.Generator().manual_seed(3)
    sd = motion_cnn.init_params(cfg, gen)
    sd["head_out.weight"] = 0.01 * torch.randn(
        sd["head_out.weight"].shape, generator=gen)
    return cfg, sd


@pytest.mark.parametrize("variant", ["bf16", "stacked", "stacked_bf16"])
def test_variant_on_the_card_is_invariant_and_near_the_cpu(dev, variant):
    """bf16 and the stacked arch on the card: one clip byte-identical in a
    batch of 1 and 4 and at T = 8 and 16, with one launch of the offsets
    kernel a chunk; f32 within 1 LSB of the CPU path, bf16 within 2 (the
    card's bf16 convolutions sum in another order)."""
    from dvsg_tpu_torch.config import StabilizeConfig
    from dvsg_tpu_torch.pipeline import stabilize as st
    params, mcfg, clips = _fast_setup(n_clips=4, frames=24)
    mcfg, params = _variant(mcfg, variant, params)
    cfg = StabilizeConfig(model=mcfg, chunk_frames=8)
    before = warp_wide.LAUNCHES
    want = st.Stabilizer(cfg, params, device=dev).stabilize_clip(clips[0])
    assert warp_wide.LAUNCHES == before + 3
    t16 = st.Stabilizer(cfg.replace(chunk_frames=16), params,
                        device=dev).stabilize_clip(clips[0])
    np.testing.assert_array_equal(t16, want)
    model = st.build_model(mcfg, params, dev)
    for b in (1, 4):
        out = st.drive_chunked_batch(st.ChunkStep(cfg, model, batched=True),
                                     clips[:b])
        np.testing.assert_array_equal(out[0], want, err_msg=f"B={b}")
    cpu = st.Stabilizer(cfg, params, device="cpu").stabilize_clip(clips[0])
    assert np.abs(cpu.astype(int) - want).max() <= (
        2 if mcfg.dtype == "bfloat16" else 1)


@pytest.mark.parametrize("variant", ["bf16", "stacked"])
def test_variant_train_step_on_the_card(dev, variant):
    """A train step of bf16 and of the stacked arch on the card: finite
    loss terms, one launch of each training kernel."""
    from dvsg_tpu_torch.config import TrainConfig
    from dvsg_tpu_torch.train import loop
    params, mcfg, _ = _fast_setup(n_clips=1, frames=8)
    mcfg, params = _variant(mcfg, variant, params)
    cfg = TrainConfig(model=mcfg, batch_size=2, steps=4, warmup_steps=1)
    state = loop.build_state(cfg, params, dev)
    before = (warp_bilinear.LAUNCHES_WARP, warp_bilinear.LAUNCHES_DIFF_FWD,
              warp_bilinear.LAUNCHES_DIFF_BWD)
    aux = loop.train_step(state, loop.step_generator(0, 0), cfg)
    assert all(np.isfinite(float(v)) for v in aux.values())
    assert (warp_bilinear.LAUNCHES_WARP, warp_bilinear.LAUNCHES_DIFF_FWD,
            warp_bilinear.LAUNCHES_DIFF_BWD) == tuple(b + 1 for b in before)


def _gelu_inputs(dev) -> torch.Tensor:
    """2**20 + 5 bf16 values from N(0, 2), then ±0, ±inf, NaN, bf16
    subnormals and values large enough to saturate tanh or overflow x³."""
    rng = np.random.default_rng(11)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 9.2e-41,
                        -9.2e-41, 5e-39, -1.1e-38, 6.0, -6.0, 30.0, -30.0,
                        1e4, -1e4, 3e38, -3e38], np.float32)
    z = np.concatenate([rng.normal(0, 2.0, (1 << 20) + 5), special])
    return torch.from_numpy(z.astype(np.float32)).to(dev).bfloat16()


def _same_bytes(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same dtype, shape, layout and bytes."""
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.stride() == b.stride()
            and torch.equal(a.view(view), b.view(view)))


@pytest.mark.parametrize("f32_out", [False, True])
def test_gelu_bf16_forward_kernel_is_the_op_chain(dev, f32_out):
    """The forward kernel gives the plain op chain's bytes on the card, one
    launch a call: vectors and a ragged end, and a view off the 16-byte
    boundary (the scalar loop)."""
    from dvsg_tpu_torch.ops import bf16_round
    x = _gelu_inputs(dev)
    for v in (x, x[1:]):
        before = bf16_round.LAUNCHES_GELU_FWD
        got = bf16_round.gelu_bf16(v, f32_out)
        assert bf16_round.LAUNCHES_GELU_FWD == before + 1
        assert _same_bytes(got, bf16_round.gelu_plain(v, f32_out))


@pytest.mark.parametrize("g_dtype", [torch.bfloat16, torch.float32])
def test_gelu_bf16_backward_kernel_is_the_op_chain(dev, g_dtype):
    """The backward kernel gives the plain chain's bytes for a bf16 and an
    f32 cotangent (rounded first), also on unaligned views and with a
    cotangent laid out otherwise than x (channels last), in the chain's
    layout."""
    from dvsg_tpu_torch.ops import bf16_round
    x = _gelu_inputs(dev)
    rng = np.random.default_rng(12)
    g = torch.from_numpy(rng.normal(0, 1.0, x.numel()).astype(np.float32)
                         ).to(dev).to(g_dtype)
    for xv, gv in ((x, g), (x[1:], g[:-1]), (x[:-2], g[2:])):
        before = bf16_round.LAUNCHES_GELU_BWD
        got = bf16_round.gelu_bf16_bwd(xv, gv)
        assert bf16_round.LAUNCHES_GELU_BWD == before + 1
        assert _same_bytes(got, bf16_round.gelu_grad_plain(xv, gv))
    x4 = x[:2 * 16 * 32 * 32].view(2, 16, 32, 32)
    g4 = g[:x4.numel()].view(2, 32, 32, 16).permute(0, 3, 1, 2)
    assert _same_bytes(bf16_round.gelu_bf16_bwd(x4, g4),
                       bf16_round.gelu_grad_plain(x4, g4))


def test_bf16_train_step_launches_the_gelu_kernels(dev, monkeypatch):
    """A bf16 train step of the corr model launches the forward kernel once
    a GELU call and the backward kernel once a GELU call."""
    from dvsg_tpu_torch.config import TrainConfig
    from dvsg_tpu_torch.models import motion_cnn
    from dvsg_tpu_torch.ops import bf16_round
    from dvsg_tpu_torch.train import loop
    params, mcfg, _ = _fast_setup(n_clips=1, frames=8)
    mcfg, params = _variant(mcfg, "bf16", params)
    cfg = TrainConfig(model=mcfg, batch_size=2, steps=4, warmup_steps=1)
    state = loop.build_state(cfg, params, dev)
    calls = []
    apply = motion_cnn._GeluBf16.apply
    monkeypatch.setattr(motion_cnn._GeluBf16, "apply",
                        lambda *a: calls.append(1) or apply(*a))
    before = bf16_round.LAUNCHES_GELU_FWD, bf16_round.LAUNCHES_GELU_BWD
    aux = loop.train_step(state, loop.step_generator(0, 0), cfg)
    assert all(np.isfinite(float(v)) for v in aux.values())
    levels = motion_cnn.pyramid_levels(mcfg)
    assert len(calls) == 1 + levels * (1 + 2 * mcfg.blocks_per_level)
    assert (bf16_round.LAUNCHES_GELU_FWD - before[0],
            bf16_round.LAUNCHES_GELU_BWD - before[1]) == (len(calls),) * 2


def test_bf16_train_steps_with_the_kernels_equal_the_chain(dev,
                                                           monkeypatch):
    """Two bf16 train steps of the corr model through the GELU kernels give
    the op chain's losses and weights bit for bit under cuDNN's
    deterministic algorithms: the kernels keep the chain's bytes and its
    output layouts, so every later op computes as before."""
    from dvsg_tpu_torch.config import TrainConfig
    from dvsg_tpu_torch.ops import bf16_round
    from dvsg_tpu_torch.train import loop
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    params, mcfg, _ = _fast_setup(n_clips=1, frames=8)
    mcfg, params = _variant(mcfg, "bf16", params)
    cfg = TrainConfig(model=mcfg, batch_size=4, steps=4, warmup_steps=1)
    runs = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(bf16_round, "_launch_fwd",
                                bf16_round.gelu_plain)
            monkeypatch.setattr(bf16_round, "_launch_bwd",
                                bf16_round.gelu_grad_plain)
        state = loop.build_state(cfg, params, dev)
        losses = [float(loop.train_step(state, loop.step_generator(2, k),
                                        cfg)["total"]) for k in range(2)]
        runs.append((losses, {n: p.detach().clone()
                              for n, p in state.model.named_parameters()}))
    assert runs[0][0] == runs[1][0]
    assert [n for n, p in runs[0][1].items()
            if not torch.equal(p, runs[1][1][n])] == []


def test_gelu_on_the_card_never_takes_the_plain_path(dev, monkeypatch):
    """bf16 CUDA tensors go to the kernels: with the plain chains made to
    raise on a CUDA tensor, the model's GELU, forward (both outputs) and
    backward, still runs (the launchers replay the chains on the meta
    device for their outputs' layout)."""
    from dvsg_tpu_torch.models import motion_cnn
    from dvsg_tpu_torch.ops import bf16_round

    def refusing(chain):
        def refuse(*args):
            if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                raise AssertionError("a CUDA tensor reached the plain path")
            return chain(*args)
        return refuse
    for name in ("gelu_plain", "gelu_grad_plain", "_gelu_gate_plain"):
        monkeypatch.setattr(bf16_round, name,
                            refusing(getattr(bf16_round, name)))
    x = _gelu_inputs(dev)[:4096].view(4, 4, 16, 16).requires_grad_()
    for f32_out in (False, True):
        y = motion_cnn.gelu(x, f32_out)
        (gx,) = torch.autograd.grad(y, x, torch.ones_like(y))
        assert gx.dtype == torch.bfloat16 and gx.shape == x.shape


# The bf16 conv + GroupNorm calls of the quality bf16 train step at batch 32
# (6 frames a clip): each pyramid level's (C, H, W).
GN_LEVELS = [(64, 128, 128), (128, 64, 64), (256, 32, 32), (256, 16, 16)]
GN_FRAMES, GN_GROUPS, GN_EPS = 192, 8, 1e-6


def _gn_case(dev, c, h, w, seed=0, batch=GN_FRAMES):
    """A conv's bf16 output without its bias, its bias, the norm's weight
    and shift, and a bf16 cotangent, drawn on the card."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def t(shape, mu, sd):
        return torch.randn(shape, generator=gen, device=dev) * sd + mu
    return (t((batch, c, h, w), 0.3, 2.0).bfloat16(), t(c, 0.0, 0.1),
            t(c, 1.0, 0.1), t(c, 0.0, 0.1),
            t((batch, c, h, w), 0.0, 1.0).bfloat16())


@pytest.mark.parametrize("shape", GN_LEVELS,
                         ids=lambda s: "x".join(map(str, s)))
def test_group_norm_bf16_kernels_against_the_chain(dev, shape):
    """At each level's shape of the quality bf16 step, every output of
    both kernels against the op chain's on the card and a float64 chain's
    (``chip_smoke.gn_against_chain``): the forward within one bf16 ulp of
    the chain's at the scale of the normalize's terms, off the float64
    output in no more values than the chain's and within one ulp of it at
    that scale (the share apart from the chain, and each one's most bf16
    steps from the float64 output, are printed); the statistics no
    farther from float64 ones than the chain's, group by group; dx off
    the float64 dx in no more values than the chain's; each f32 gradient
    no farther from float64 than the chain's in its worst channel. Two
    runs byte-equal; one launch of each kernel a call."""
    import chip_smoke
    from dvsg_tpu_torch.ops import bf16_round
    x, bias, weight, beta, g = _gn_case(dev, *shape)
    args = (GN_GROUPS, GN_EPS)
    runs = []
    for _ in range(2):
        before = bf16_round.LAUNCHES_GN_FWD, bf16_round.LAUNCHES_GN_BWD
        y, stats = bf16_round.group_norm_bf16(x, bias, weight, beta, *args)
        grads = bf16_round.group_norm_bf16_bwd(g, x, stats, bias, weight,
                                               *args)
        assert (bf16_round.LAUNCHES_GN_FWD - before[0],
                bf16_round.LAUNCHES_GN_BWD - before[1]) == (1, 1)
        runs.append([y, stats, *grads])
    for a, b in zip(*runs):
        assert torch.equal(a, b) and a.stride() == b.stride()
    rec = chip_smoke.gn_against_chain(runs[0], x, bias, weight, beta, g,
                                      *args)
    print(f"{shape}: out {100 * rec['out_differ'] / x.numel():.4f} % from "
          f"the chain; kernel / chain: {rec}")


def test_group_norm_bf16_kernels_take_any_group_count(dev):
    """Group counts that divide C (a tensor-parallel shard's 4, 2, 1, and
    one channel a group), an odd H x W and a view off 16 bytes (the scalar
    paths), a group too large for a cluster's shared memory (read twice),
    a batch of one: the forward within one ulp of the chain's at its
    terms' scale, dx off the float64 chain's in no more values than the
    chain's, give or take a ten-thousandth of them, bit-identical on a
    second run."""
    import chip_smoke
    from dvsg_tpu_torch.ops import bf16_round
    cases = [((4, 64, 32, 32), 4), ((4, 64, 32, 32), 2), ((4, 64, 32, 32), 1),
             ((2, 16, 8, 8), 16), ((3, 32, 7, 9), 8), ((1, 256, 96, 96), 1),
             ((2, 64, 128, 128), 8)]
    for (b, c, h, w), groups in cases:
        x, bias, weight, beta, g = _gn_case(dev, c, h, w, seed=c + h,
                                            batch=b)
        views = [(x, g)]
        if h * w % 8 == 0:
            xs = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
            xs[1:].copy_(x.flatten())
            views.append((xs[1:].view(x.shape), g))
        for xv, gv in views:
            outs = []
            for _ in range(2):
                y, stats = bf16_round.group_norm_bf16(xv, bias, weight, beta,
                                                      groups, GN_EPS)
                outs.append([y, stats, *bf16_round.group_norm_bf16_bwd(
                    gv, xv, stats, bias, weight, groups, GN_EPS)])
            for a, a2 in zip(*outs):
                assert torch.equal(a, a2)
            want, st = bf16_round.group_norm_bf16_plain(xv, bias, weight,
                                                        beta, groups, GN_EPS)
            assert chip_smoke.gn_ulps_at_scale(
                outs[0][0], want, xv, bias, weight, beta, st, groups,
                GN_EPS) <= 1.0, (b, c, h, w)
            ref = chip_smoke.gn_chain64(xv, bias, weight, beta, gv, groups,
                                        GN_EPS)
            dxc = bf16_round.group_norm_bf16_grad_plain(
                gv, xv, st, bias, weight, groups, GN_EPS)[0]
            nk = int((outs[0][2] != ref[2]).sum())
            nc = int((dxc != ref[2]).sum())
            assert nk <= nc + x.numel() // 10000, (b, c, h, w, groups, nk, nc)


def test_group_norm_bf16_kernels_refuse_what_they_do_not_take(dev):
    """A channels-last or f32 x, a group count that does not divide C, f32
    parameters of another length or on the CPU raise; a channels-last
    cotangent is copied to NCHW."""
    from dvsg_tpu_torch.ops import bf16_round
    x, bias, weight, beta, g = _gn_case(dev, 32, 8, 8, batch=2)
    bad = [((x.contiguous(memory_format=torch.channels_last), bias, weight,
             beta, 8, GN_EPS), "NCHW contiguous"),
           ((x.float(), bias, weight, beta, 8, GN_EPS), "bf16"),
           ((x, bias, weight, beta, 5, GN_EPS), "do not divide"),
           ((x, bias[:16], weight, beta, 8, GN_EPS), "parameters"),
           ((x, bias.cpu(), weight, beta, 8, GN_EPS), "parameters"),
           ((x, bias.double(), weight, beta, 8, GN_EPS), "parameters")]
    for args, match in bad:
        with pytest.raises(ValueError, match=match):
            bf16_round.group_norm_bf16(*args)
    _, stats = bf16_round.group_norm_bf16(x, bias, weight, beta, 8, GN_EPS)
    with pytest.raises(ValueError, match="g must be bf16"):
        bf16_round.group_norm_bf16_bwd(g.float(), x, stats, bias, weight, 8,
                                       GN_EPS)
    want = bf16_round.group_norm_bf16_bwd(g, x, stats, bias, weight, 8,
                                          GN_EPS)
    got = bf16_round.group_norm_bf16_bwd(
        g.contiguous(memory_format=torch.channels_last), x, stats, bias,
        weight, 8, GN_EPS)
    for a, b in zip(got, want):
        assert torch.equal(a, b) and a.is_contiguous()


def test_bf16_train_step_launches_the_group_norm_kernels(dev, monkeypatch):
    """A bf16 train step of the corr model launches each GroupNorm kernel
    twice a ResBlock (2 x levels x blocks) and never the op chain: the
    plain functions refuse a CUDA tensor."""
    from dvsg_tpu_torch.config import TrainConfig
    from dvsg_tpu_torch.models import motion_cnn
    from dvsg_tpu_torch.ops import bf16_round
    from dvsg_tpu_torch.train import loop

    def refusing(chain):
        def refuse(*args):
            if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                raise AssertionError("a CUDA tensor reached the plain path")
            return chain(*args)
        return refuse
    for name in ("group_norm_bf16_plain", "group_norm_bf16_grad_plain"):
        monkeypatch.setattr(bf16_round, name,
                            refusing(getattr(bf16_round, name)))
    params, mcfg, _ = _fast_setup(n_clips=1, frames=8)
    mcfg, params = _variant(mcfg, "bf16", params)
    cfg = TrainConfig(model=mcfg, batch_size=2, steps=4, warmup_steps=1)
    state = loop.build_state(cfg, params, dev)
    before = bf16_round.LAUNCHES_GN_FWD, bf16_round.LAUNCHES_GN_BWD
    aux = loop.train_step(state, loop.step_generator(0, 0), cfg)
    assert all(np.isfinite(float(v)) for v in aux.values())
    n = 2 * motion_cnn.pyramid_levels(mcfg) * mcfg.blocks_per_level
    assert (bf16_round.LAUNCHES_GN_FWD - before[0],
            bf16_round.LAUNCHES_GN_BWD - before[1]) == (n, n)


def test_profiler_traces_the_kernel_on_the_card(dev, tmp_path):
    """torch.profiler sees the ctypes-launched offsets kernel on the card:
    the summary counts it once a chunk and the device lane has an idle
    share."""
    from dvsg_tpu_torch.config import StabilizeConfig
    from dvsg_tpu_torch.pipeline import stabilize as st
    from dvsg_tpu_torch.utils import profiling
    params, mcfg, clips = _fast_setup(n_clips=1, frames=24)
    stab = st.Stabilizer(StabilizeConfig(model=mcfg, chunk_frames=8),
                         params, device=dev)
    stab.stabilize_clip(clips[0])
    with profiling.trace(str(tmp_path), dev):
        stab.stabilize_clip(clips[0])
    summary = profiling.summarize_trace(str(tmp_path), min_us=0.0)
    b1 = [v["count"] for k, v in summary.items()
          if "warp_u8_offsets_packed_kernel" in k]
    assert b1 == [3]
    busy = profiling.device_busy_stats(str(tmp_path))
    assert 0.0 <= busy["idle_pct"] < 100.0 and busy["busy_ms"] > 0


def test_spans_stay_host_ops_on_the_card(dev):
    """A profiled train step on the card: its ``draw`` and ``render``
    spans are host ops, none is copied onto the device lane, and B2's
    render kernel is launched inside ``render``."""
    from torch.profiler import ProfilerActivity, profile
    from dvsg_tpu_torch.config import TrainConfig
    from dvsg_tpu_torch.parallel import dryrun
    from dvsg_tpu_torch.train import loop
    mcfg, params = dryrun.tiny_setup()
    cfg = TrainConfig(model=mcfg, batch_size=2, steps=4, warmup_steps=1)
    state = loop.build_state(cfg, params, device=dev)
    loop.train_step(state, loop.step_generator(0, 0), cfg)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        loop.train_step(state, loop.step_generator(0, 1), cfg)
        torch.cuda.synchronize(dev)
    events = list(prof.profiler.kineto_results.events())
    cuda = torch.autograd.DeviceType.CUDA
    spans = [e for e in events if e.name().startswith("dvsg.")]
    assert sorted(e.name() for e in spans) == ["dvsg.draw", "dvsg.render"]
    assert all(e.device_type() != cuda and not e.is_user_annotation()
               for e in spans)
    render = next(e for e in spans if e.name() == "dvsg.render")
    host = {e.correlation_id(): e for e in events if e.device_type() != cuda}
    launched = [host.get(e.linked_correlation_id()) for e in events
                if e.device_type() == cuda and "warp_f32" in e.name()]
    assert any(op is not None and render.start_ns() <= op.start_ns()
               <= render.start_ns() + render.duration_ns()
               for op in launched)


# --- the training step's draws on the card -----------------------------------

def _tiny_train(dev, with_bank):
    """(TrainConfig, bank on the card or None) of a tiny training run."""
    from dvsg_tpu_torch.config import TrainConfig
    from dvsg_tpu_torch.parallel import dryrun
    mcfg, _ = dryrun.tiny_setup()
    cfg = TrainConfig(model=mcfg, batch_size=4, steps=8, warmup_steps=1)
    bank = (torch.rand((5, *mcfg.model_size, 3),
                       generator=torch.Generator().manual_seed(5)).to(dev)
            if with_bank else None)
    return cfg, bank


def _blocking_draws(generator, cfg, bank, dev):
    """The step's draws made one by one from ``generator`` and moved to
    the card by blocking copies from pageable memory, then built on the
    card (draw_batch's outputs as a plain sequence of calls)."""
    from dvsg_tpu_torch.train import synthetic
    b, clip_len = cfg.batch_size, cfg.model.window + 1
    if bank is None:
        stills = synthetic.still_from_octaves(
            [torch.rand((b, res, res, 3), generator=generator).to(dev)
             for res, _ in synthetic.STILL_OCTAVES], *cfg.model.model_size)
    else:
        idx = torch.randint(0, len(bank), (b,), generator=generator)
        flips = (torch.rand((b, 2), generator=generator) < 0.5).to(dev)
        stills = bank[idx.to(dev)]
        stills = torch.where(flips[:, 0, None, None, None],
                             stills.flip(2), stills)
        stills = torch.where(flips[:, 1, None, None, None],
                             stills.flip(1), stills)
    steps = torch.randn((b, clip_len + 8, 5), generator=generator)
    mag = 0.3 + 0.7 * torch.rand((b, 5), generator=generator)
    paths = synthetic.camera_path_from_draws(steps.to(dev), mag.to(dev))
    gains = 1.0 + 0.03 * (2.0 * torch.rand((b, clip_len),
                                           generator=generator) - 1.0)
    return stills, paths, gains.to(dev)


@pytest.mark.parametrize("with_bank", [False, True])
def test_warm_train_step_makes_no_host_sync(dev, with_bank):
    """After one warm-up step (which uploads the cached resize matrices
    and path bounds), train_step runs under sync debug mode "error": no
    call in the step waits for the card."""
    from dvsg_tpu_torch.parallel import dryrun
    from dvsg_tpu_torch.train import loop
    cfg, bank = _tiny_train(dev, with_bank)
    state = loop.build_state(cfg, dryrun.tiny_setup()[1], device=dev)
    loop.train_step(state, loop.step_generator(0, 0), cfg, bank)
    torch.cuda.synchronize(dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for step in range(1, 2 if with_bank else 3):
            loop.train_step(state, loop.step_generator(0, step), cfg, bank)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize(dev)


@pytest.mark.parametrize("with_bank", [False, True])
def test_draws_on_the_card_equal_the_blocking_path(dev, with_bank,
                                                   monkeypatch):
    """draw_batch's stills, paths and gains on the card equal the blocking
    path's bit for bit, for several (seed, step); and three train steps'
    losses equal those of a twin state that draws through the blocking
    path."""
    from dvsg_tpu_torch.parallel import dryrun
    from dvsg_tpu_torch.train import loop
    cfg, bank = _tiny_train(dev, with_bank)
    for seed, step in ((0, 0), (7, 3), (4170000041, 12)):
        got = loop.draw_batch(loop.step_generator(seed, step), cfg, bank,
                              dev)
        want = _blocking_draws(loop.step_generator(seed, step), cfg, bank,
                               dev)
        for name, g, w in zip(("stills", "paths", "gains"), got, want):
            assert g.device == w.device and torch.equal(g, w), (
                name, seed, step)

    params = dryrun.tiny_setup()[1]
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    losses = {}
    for path in ("pinned", "blocking"):
        if path == "blocking":
            monkeypatch.setattr(
                loop, "draw_batch",
                lambda gen, c, bk, d: _blocking_draws(gen, c, bk, d))
        state = loop.build_state(cfg, params, device=dev)
        losses[path] = [float(loop.train_step(
            state, loop.step_generator(3, k), cfg, bank)["total"])
            for k in range(3)]
    assert losses["pinned"] == losses["blocking"]
