"""The port's two-pass auto border-crop (pipeline/autocrop.py) and online
push API (pipeline/online.py) on the CPU: the crop against the JAX
package's on the committed fast model (equal), and both against the port's
own clip pipeline (mirrors of tests/test_autocrop.py and
tests/test_online.py)."""

import functools
import os

import numpy as np
import pytest
import torch

from dvsg_tpu.config import StabilizeConfig as JStabilizeConfig
from dvsg_tpu.pipeline import autocrop as jautocrop
from dvsg_tpu.utils import checkpoint as jckpt
from dvsg_tpu_torch.config import ModelConfig, StabilizeConfig
from dvsg_tpu_torch.models import motion_cnn
from dvsg_tpu_torch.ops import grid as grid_ops
from dvsg_tpu_torch.pipeline import autocrop
from dvsg_tpu_torch.pipeline.online import OnlineStabilizer
from dvsg_tpu_torch.pipeline.stabilize import Stabilizer, put_frames
from dvsg_tpu_torch.train import synthetic
from dvsg_tpu_torch.utils.checkpoint import load_npz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAST = os.path.join(ROOT, "checkpoints", "flagship_fast.npz")
MCFG = ModelConfig(window=3, model_size=(32, 32), grid_size=(8, 8),
                   base_features=8, blocks_per_level=1)
CFG = StabilizeConfig(model=MCFG, chunk_frames=4)


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


def _clip(n, key=7, h=40, w=48):
    return synthetic.synthetic_clip_u8(torch.Generator().manual_seed(key),
                                       n, h, w)[0].numpy()


class _Reader:
    def __init__(self, frames):
        self.frames, self.pos = frames, 0

    def read_batch(self, n):
        out = self.frames[self.pos:self.pos + n]
        self.pos += len(out)
        return out


# --- auto border-crop ------------------------------------------------------------

class TestCropMath:
    @pytest.mark.parametrize("m,want", [(0.0, (0.0, False)),
                                        (0.1, (4 / 64, False)),
                                        (0.125, (4 / 64, False)),
                                        (1.5, (31 / 64, True))])
    def test_crop_for_max_offset(self, m, want):
        assert autocrop.crop_for_max_offset(m) == want
        assert autocrop.crop_for_max_offset(m) \
            == jautocrop.crop_for_max_offset(m)

    def test_monotone(self):
        crops = [autocrop.crop_for_max_offset(m)[0]
                 for m in np.linspace(0, 1.0, 33)]
        assert all(b >= a for a, b in zip(crops, crops[1:]))

    @pytest.mark.parametrize("kw", [dict(path_smooth=0),
                                    dict(path_smooth=8),
                                    dict(path_smooth=8,
                                         path_smooth_rotation=False),
                                    dict(path_smooth=8,
                                         path_smooth_rotation=False,
                                         path_smooth_scale=False)])
    def test_smoothing_margin_matches_reference(self, kw):
        assert autocrop.smoothing_margin(StabilizeConfig(**kw)) \
            == jautocrop.smoothing_margin(JStabilizeConfig(**kw))


@functools.cache
def _reference_scan():
    """The JAX package's pass 1 over the shaky clip (no smoothing margin):
    (crop, max |offset|, capped)."""
    jparams, jmcfg = jckpt.load_npz(FAST)
    return jautocrop.pick_border_crop(
        JStabilizeConfig(model=jmcfg, chunk_frames=4, warp_impl="lax"),
        jparams, _clip(10, key=7, h=64, w=96))


@pytest.mark.parametrize("path_smooth", [0, 8])
def test_pick_border_crop_equals_reference(path_smooth):
    """The committed fast model on a shaky clip: the reference's crop for
    its scanned max plus the same smoothing margin, and the max |offset|
    within f32 rounding of the CNN."""
    params, mcfg = load_npz(FAST)
    cfg = StabilizeConfig(model=mcfg, chunk_frames=4,
                          path_smooth=path_smooth)
    crop, m, capped = autocrop.pick_border_crop(
        cfg, params, _clip(10, key=7, h=64, w=96), device="cpu")
    _, m_ref, _ = _reference_scan()
    m_ref += jautocrop.smoothing_margin(JStabilizeConfig(
        path_smooth=path_smooth))
    assert (crop, capped) == jautocrop.crop_for_max_offset(m_ref)
    assert m == pytest.approx(m_ref, abs=1e-5)
    assert crop > 0


def test_picked_crop_keeps_every_coordinate_in_frame(params):
    """Every applied coordinate of the smoothed pass 2 stays in [-1, 1]."""
    cfg = CFG.replace(path_smooth=8)
    frames = _clip(12)
    crop, m, capped = autocrop.pick_border_crop(cfg, params, frames,
                                                device="cpu")
    assert not capped and crop >= m / 2
    stab = Stabilizer(cfg.replace(border_crop=crop), params, device="cpu")
    stab.begin_stream()
    halo = stab._initial_halo(frames[0])
    for start in range(0, 12, 4):
        _, halo, offs = stab._chunk(put_frames(frames[start:start + 4],
                                               "cpu"), halo)
        g = grid_ops.grid_from_offsets(offs, 40, 48, crop)
        assert float(g.abs().max()) <= 1.0 + 1e-6


def test_stream_scan_equals_clip_scan(params):
    frames = _clip(10)       # a partial last chunk: padding counts in both
    a = autocrop.scan_clip_max_offset(CFG, params, frames, device="cpu")
    b = autocrop.scan_stream_max_offset(CFG, params, _Reader(frames),
                                        device="cpu")
    assert a == b > 0
    assert autocrop.scan_clip_max_offset(CFG, params, frames[:0],
                                         device="cpu") == 0.0


def test_autocrop_covers_smoothing_clamp(params):
    frames = np.zeros((4, 40, 48, 3), np.uint8)
    plain, _, _ = autocrop.pick_border_crop(CFG, params, frames,
                                            device="cpu")
    smooth, _, _ = autocrop.pick_border_crop(CFG.replace(path_smooth=8),
                                             params, frames, device="cpu")
    assert smooth >= plain + CFG.path_smooth_max - 1 / 64


# --- online push -----------------------------------------------------------------

@pytest.mark.parametrize("path_smooth", [0, 8])
def test_online_push_equals_clip(params, path_smooth):
    cfg = CFG.replace(path_smooth=path_smooth)
    frames = _clip(11)
    online = OnlineStabilizer(cfg, params, device="cpu")
    got = [f for frame in frames for f in online.push(frame)]
    got += online.flush()
    want = Stabilizer(cfg, params, device="cpu").stabilize_clip(frames)
    np.testing.assert_array_equal(np.stack(got), want)


def test_online_chunk_of_one_and_reset(params):
    cfg = CFG.replace(chunk_frames=1, path_smooth=8)
    frames = _clip(5)
    online = OnlineStabilizer(cfg, params, device="cpu")
    first = []
    for f in frames:
        res = online.push(f)
        assert len(res) == 1                  # frame-level latency
        first += res
    assert online.flush() == []               # empty buffer: stays open
    online.reset()
    again = [f for frame in frames for f in online.push(frame)]
    np.testing.assert_array_equal(np.stack(again), np.stack(first))
    np.testing.assert_array_equal(
        np.stack(first),
        Stabilizer(cfg, params, device="cpu").stabilize_clip(frames))


def test_online_push_after_flush_raises_until_reset(params):
    frames = _clip(6)
    online = OnlineStabilizer(CFG.replace(path_smooth=8), params,
                              device="cpu")
    for f in frames:
        online.push(f)
    assert len(online.flush()) == 2
    with pytest.raises(RuntimeError, match="ended by flush"):
        online.push(frames[0])
    online.reset()
    assert online.push(frames[0]) == []


@pytest.mark.parametrize("frame,err,match", [
    (np.zeros((40, 48, 3), np.float32), TypeError, "uint8"),
    (np.zeros((2, 40, 48, 3), np.uint8), ValueError, "one"),
])
def test_online_refuses_bad_frames(params, frame, err, match):
    online = OnlineStabilizer(CFG, params, device="cpu")
    with pytest.raises(err, match=match):
        online.push(frame)


def test_online_refuses_lag_and_defaults_to_the_card(params, monkeypatch):
    with pytest.raises(ValueError, match="path_smooth_lag"):
        OnlineStabilizer(CFG.replace(path_smooth=8, path_smooth_lag=4),
                         params, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OnlineStabilizer(CFG, params)
