"""The port's overlapped stream loop (pipeline/overlap.py) on the CPU:
byte-identical to the sync stream over several runs and ring depths, its
refusals, and the retirement of its worker threads on failure (mirrors of
the reference's overlap tests)."""

import os
import threading

import numpy as np
import pytest
import torch

from dvsg_tpu_torch import cli
from dvsg_tpu_torch.config import ModelConfig, StabilizeConfig
from dvsg_tpu_torch.models import motion_cnn
from dvsg_tpu_torch.pipeline.overlap import stabilize_stream_overlapped
from dvsg_tpu_torch.pipeline.stabilize import Stabilizer
from dvsg_tpu_torch.train import synthetic
from dvsg_tpu_torch.utils import video_io
from dvsg_tpu_torch.utils.metrics import StageTimer

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
    gen = torch.Generator().manual_seed(0)
    p = motion_cnn.init_params(MCFG, gen)
    p["head_out.weight"] = 0.05 * torch.randn(p["head_out.weight"].shape,
                                              generator=gen)
    return p


@pytest.fixture(scope="module")
def frames():
    return synthetic.synthetic_clip_u8(torch.Generator().manual_seed(6), 14,
                                       40, 48)[0].numpy()


class _Reader:
    def __init__(self, frames, fail_at=None):
        self.frames, self.pos, self.fail_at = frames, 0, fail_at

    def read_batch(self, n):
        if self.fail_at is not None and self.pos >= self.fail_at:
            raise OSError("injected decoder failure")
        out = self.frames[self.pos:self.pos + n]
        self.pos += len(out)
        return out


class _Writer:
    def __init__(self, fail_at=None):
        self.chunks, self.fail_at = [], fail_at

    def write_batch(self, frames):
        if len(self.chunks) == self.fail_at:
            raise OSError("injected encoder failure")
        self.chunks.append(np.array(frames))


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("path_smooth", [0, 8])
def test_overlapped_equals_sync(params, frames, depth, path_smooth):
    """Several runs through one stabilizer: the same bytes as the sync
    stream each time, whatever the ring depth."""
    cfg = CFG.replace(path_smooth=path_smooth, queue_depth=depth)
    stab = Stabilizer(cfg, params, device="cpu")
    want = _Writer()
    assert stab.stabilize_stream(_Reader(frames), want) == len(frames)
    for _ in range(3):
        w = _Writer()
        timer = StageTimer()
        assert stabilize_stream_overlapped(stab, _Reader(frames), w,
                                           timer=timer) == len(frames)
        np.testing.assert_array_equal(np.concatenate(w.chunks),
                                      np.concatenate(want.chunks))
    assert timer.summary()["dispatch"]["count"] == 4
    assert {"decode_wait", "h2d", "d2h", "encode_wait"} \
        <= set(timer.summary())


@pytest.mark.parametrize("n_frames,chunks", [(14, 4), (12, 3)])
def test_worker_threads_time_decode_and_encode(params, frames, n_frames,
                                               chunks):
    """The worker threads' stages: ``encode`` once a chunk, ``decode``
    once a ``read_batch``, as the sync stream's ``decode`` counts (a clip
    that fills its last chunk is read once more to find its end)."""
    stab = Stabilizer(CFG, params, device="cpu")
    sync, timer = StageTimer(), StageTimer()
    stab.stabilize_stream(_Reader(frames[:n_frames]), _Writer(), timer=sync)
    w = _Writer()
    assert stabilize_stream_overlapped(stab, _Reader(frames[:n_frames]), w,
                                       timer=timer) == n_frames
    got = timer.summary()
    assert got["encode"]["count"] == len(w.chunks) == chunks
    assert got["decode"]["count"] == sync.summary()["decode"]["count"] \
        == chunks + (n_frames % CFG.chunk_frames == 0)
    assert got["dispatch"]["count"] == chunks
    assert got["decode"]["total_s"] > 0 and got["encode"]["total_s"] > 0


def test_overlapped_refuses_lag(params, frames):
    stab = Stabilizer(CFG.replace(path_smooth=8, path_smooth_lag=4), params,
                      device="cpu")
    with pytest.raises(ValueError, match="path_smooth_lag"):
        stabilize_stream_overlapped(stab, _Reader(frames), _Writer())


@pytest.mark.parametrize("reader_fail,writer_fail", [(8, None), (None, 1)])
def test_failures_raise_and_retire_the_workers(params, frames, reader_fail,
                                               writer_fail):
    stab = Stabilizer(CFG.replace(queue_depth=1), params, device="cpu")
    with pytest.raises(OSError, match="injected"):
        stabilize_stream_overlapped(stab, _Reader(frames, reader_fail),
                                    _Writer(writer_fail))
    workers = [t for t in threading.enumerate()
               if t.name.endswith(("(_decode_worker)", "(_encode_worker)"))]
    assert workers == []


def test_empty_stream(params):
    stab = Stabilizer(CFG, params, device="cpu")
    empty = np.zeros((0, 40, 48, 3), np.uint8)
    assert stabilize_stream_overlapped(stab, _Reader(empty), _Writer()) == 0


def test_cli_overlap_refusals(tmp_path, capsys):
    base = ["stabilize", "--input", str(tmp_path), "--output",
            str(tmp_path / "o"), "--platform", "cpu", "--overlap"]
    assert cli.main(base + ["--resume-dir", str(tmp_path / "r")]) == 2
    assert "no resume support" in capsys.readouterr().err
    assert cli.main(base + ["--path-smooth", "8",
                            "--path-smooth-lag", "4"]) == 2
    assert "path_smooth_lag" in capsys.readouterr().err


def test_cli_overlap_writes_the_sync_output(frames, tmp_path):
    with video_io.VideoWriter(str(tmp_path / "in"), 48, 40) as w:
        w.write_batch(frames)
    outs = {}
    for name, extra in (("sync", []), ("overlap", ["--overlap"])):
        assert cli.main(["stabilize", "--input", str(tmp_path / "in"),
                         "--output", str(tmp_path / name), "--platform",
                         "cpu", "--chunk-frames", "4", "--path-smooth",
                         "8", *extra]) == 0
        with video_io.VideoReader(str(tmp_path / name)) as r:
            outs[name] = r.read_batch(100)
    assert outs["sync"].shape == frames.shape
    np.testing.assert_array_equal(outs["overlap"], outs["sync"])
    assert os.listdir(tmp_path / "overlap")
