"""The port's stabilize pipeline and CLI against the JAX package on the CPU.

``Stabilizer(device="cpu")`` on the committed fast checkpoint holds within
1 LSB of the JAX ``Stabilizer`` (lax warp): the offsets agree to ~1e-6
and the warp rounds the same values, so a pixel can only differ where its
value sits at a rounding boundary. Chunk size, streaming and resume are
byte-identical within the port, as in the reference.
"""

import os

import jax
import numpy as np
import pytest

from dvsg_tpu.config import StabilizeConfig as JStabilizeConfig
from dvsg_tpu.pipeline.stabilize import Stabilizer as JStabilizer
from dvsg_tpu.train import synthetic
from dvsg_tpu.utils import checkpoint as jckpt
from dvsg_tpu_torch import cli
from dvsg_tpu_torch.config import StabilizeConfig
from dvsg_tpu_torch.pipeline import stabilize as tstab
from dvsg_tpu_torch.utils import video_io
from dvsg_tpu_torch.utils.checkpoint import load_npz
from dvsg_tpu_torch.utils.metrics import StageTimer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAST = os.path.join(ROOT, "checkpoints", "flagship_fast.npz")


@pytest.fixture(scope="module")
def clip():
    frames, still, _ = synthetic.synthetic_clip_u8(jax.random.key(3), 10,
                                                   64, 96)
    return np.array(frames), np.array(still)


@pytest.fixture(scope="module")
def fast():
    return load_npz(FAST)


def _stab(fast, **kw):
    params, mcfg = fast
    return tstab.Stabilizer(StabilizeConfig(model=mcfg, **kw), params,
                            device="cpu")


class MemReader:
    def __init__(self, frames):
        self.frames, self.pos = frames, 0

    def read_batch(self, n):
        out = self.frames[self.pos:self.pos + n]
        self.pos += len(out)
        return out

    def skip(self, n):
        k = min(n, len(self.frames) - self.pos)
        self.pos += k
        return k


class MemWriter:
    def __init__(self, frames):
        self.frames, self.pos = frames, 0

    def seek(self, i):
        self.pos = i

    def write_batch(self, frames):
        self.frames[self.pos:self.pos + len(frames)] = frames
        self.pos += len(frames)


@pytest.mark.parametrize("kw", [{}, dict(strength=0.5, border_crop=0.05)])
def test_clip_within_1lsb_of_reference(clip, fast, kw):
    frames, _ = clip
    jparams, jmcfg = jckpt.load_npz(FAST)
    ref = JStabilizer(JStabilizeConfig(model=jmcfg, chunk_frames=4,
                                       warp_impl="lax", **kw),
                      jparams).stabilize_clip(frames)
    ours = _stab(fast, chunk_frames=4, **kw).stabilize_clip(frames)
    assert ours.shape == frames.shape and ours.dtype == np.uint8
    assert np.abs(ours.astype(int) - ref).max() <= 1


def test_stabilizes_the_shaky_clip(clip, fast):
    """The model really moves pixels: output differs from input by much
    more than rounding. Every chunk is counted; none falls back."""
    frames, _ = clip
    stab = _stab(fast, chunk_frames=4)
    out = stab.stabilize_clip(frames)
    assert np.abs(out.astype(int) - frames).mean() > 1.0
    assert stab.chunks_seen == 3 and stab.coverage_fallbacks == 0


def test_normalize_and_quantize_match_reference():
    import jax.numpy as jnp
    from dvsg_tpu.pipeline import stabilize as jstab
    import torch
    rng = np.random.default_rng(5)
    u8 = rng.integers(0, 256, (2, 5, 7, 3), dtype=np.uint8)
    f = rng.uniform(-0.1, 1.1, (2, 5, 7, 3)).astype(np.float32)
    f[0, 0, :4, 0] = np.array([0.5, 1.5, 2.5, 254.5], np.float32) / 255
    np.testing.assert_array_equal(
        tstab.normalize_frames(torch.from_numpy(u8)).numpy(),
        np.asarray(jstab.normalize_frames(jnp.asarray(u8))))
    np.testing.assert_array_equal(
        tstab.quantize_frames(torch.from_numpy(f)).numpy(),
        np.asarray(jstab.quantize_frames(jnp.asarray(f))))


@pytest.mark.parametrize("t_small,t_big", [(2, 4), (3, 8)])
def test_chunk_size_invariant(clip, fast, t_small, t_big):
    frames, _ = clip
    a = _stab(fast, chunk_frames=t_small).stabilize_clip(frames)
    b = _stab(fast, chunk_frames=t_big).stabilize_clip(frames)
    np.testing.assert_array_equal(a, b)


def test_short_and_empty_clips(fast):
    rng = np.random.default_rng(0)
    two = rng.integers(0, 256, (2, 32, 40, 3), dtype=np.uint8)
    stab = _stab(fast, chunk_frames=4)
    assert stab.stabilize_clip(two).shape == two.shape
    empty = np.zeros((0, 32, 40, 3), np.uint8)
    assert stab.stabilize_clip(empty).shape == empty.shape


def test_initial_halo_replicates_first_frame(clip, fast):
    frames, _ = clip
    halo = tstab.initial_halo(_stab(fast).cfg, frames[0], "cpu")
    assert halo.shape == (4, 128, 128, 3)
    assert all(np.array_equal(halo[0].numpy(), h.numpy()) for h in halo)


def test_stream_with_resume_equals_clip(clip, fast, tmp_path):
    frames, _ = clip
    stab = _stab(fast, chunk_frames=4)
    want = stab.stabilize_clip(frames)
    resume = str(tmp_path / "resume")
    got = np.zeros_like(frames)
    # First run dies after two chunks (its input ends at frame 8).
    n1 = stab.stabilize_stream(MemReader(frames[:8]), MemWriter(got),
                               resume_dir=resume)
    assert n1 == 8
    with np.load(os.path.join(resume, "resume_state.npz")) as z:
        assert int(z["frames_written"]) == 8
    got[8:] = 0
    timer = StageTimer()
    n2 = stab.stabilize_stream(MemReader(frames), MemWriter(got),
                               timer=timer, resume_dir=resume)
    assert n2 == len(frames)
    np.testing.assert_array_equal(got, want)
    assert timer.summary()["compute"]["count"] == 1


def test_stream_refuses_a_smoothing_record(clip, fast, tmp_path):
    frames, _ = clip
    resume = tmp_path / "r"
    resume.mkdir()
    np.savez(resume / "resume_state.npz", halo=np.zeros((4, 128, 128, 3)),
             frames_written=4, smooth_state=np.zeros(4))
    with pytest.raises(ValueError, match="not ported yet"):
        _stab(fast, chunk_frames=4).stabilize_stream(
            MemReader(frames), MemWriter(np.zeros_like(frames)),
            resume_dir=str(resume))


def _write_dir(path, frames):
    with video_io.VideoWriter(str(path), frames.shape[2],
                              frames.shape[1]) as w:
        w.write_batch(frames)


def _read_dir(path):
    with video_io.VideoReader(str(path)) as r:
        return r.read_batch(1000)


def test_cli_frame_dir_matches_library(clip, fast, tmp_path):
    frames = clip[0][:6]
    _write_dir(tmp_path / "in", frames)
    rc = cli.main(["stabilize", "--input", str(tmp_path / "in"),
                   "--output", str(tmp_path / "out"), "--platform", "cpu",
                   "--chunk-frames", "4", "--border-crop", "0.05"])
    assert rc == 0
    want = _stab(fast, chunk_frames=4, border_crop=0.05).stabilize_clip(
        frames)
    np.testing.assert_array_equal(_read_dir(tmp_path / "out"), want)


def test_cli_resume_dir_and_quality_preset(clip, tmp_path):
    frames = clip[0][:6]
    _write_dir(tmp_path / "in", frames)
    args = ["stabilize", "--input", str(tmp_path / "in"), "--output",
            str(tmp_path / "out"), "--platform", "cpu", "--chunk-frames",
            "4", "--preset", "quality", "--resume-dir", str(tmp_path / "r")]
    assert cli.main(args) == 0
    first = _read_dir(tmp_path / "out")
    assert first.shape == frames.shape
    assert cli.main(args) == 0          # complete record: nothing redone
    np.testing.assert_array_equal(_read_dir(tmp_path / "out"), first)


@pytest.mark.parametrize("extra", [
    ["--path-smooth", "32"], ["--path-smooth-lag", "8"],
    ["--path-smooth-no-rotation"], ["--overlap"], ["--artifact", "m.dvsgx"],
    ["--profile-dir", "p"], ["--border-crop", "auto"],
    ["--border-crop", "0.5"], ["--strength", "3"], ["--chunk-frames", "0"],
    ["--checkpoint", "nope.npz"],
])
def test_cli_refuses_unported_and_bad_flags(tmp_path, extra, capsys):
    rc = cli.main(["stabilize", "--input", str(tmp_path), "--output",
                   str(tmp_path / "o"), "--platform", "cpu", *extra])
    assert rc == 2
    err = capsys.readouterr().err
    if extra[0] in ("--path-smooth", "--path-smooth-lag", "--overlap",
                    "--artifact", "--profile-dir",
                    "--path-smooth-no-rotation") or "auto" in extra:
        assert "not ported yet" in err


def test_cli_resume_needs_frame_dir_output(tmp_path):
    rc = cli.main(["stabilize", "--input", str(tmp_path), "--output",
                   str(tmp_path / "o.mp4"), "--platform", "cpu",
                   "--resume-dir", str(tmp_path / "r")])
    assert rc == 2


def test_cli_needs_the_stabilize_command():
    assert cli.main([]) == 2
    assert cli.main(["stabilize-batch"]) == 2      # not a command here
    with pytest.raises(SystemExit) as e:           # a command, bad usage
        cli.main(["train"])
    assert e.value.code == 2


def test_video_io_container_roundtrip_and_errors(clip, tmp_path):
    frames = clip[0][:4]
    path = str(tmp_path / "c.avi")
    assert video_io.is_container_path(path)
    with video_io.VideoWriter(path, 96, 64) as w:
        assert not w.appendable
        w.write_batch(frames)
        with pytest.raises(ValueError, match="container"):
            w.seek(2)
        with pytest.raises(ValueError, match="shape"):
            w.write(frames[0, :32])
    with video_io.VideoReader(path) as r:
        back = r.read_batch(10)
    assert back.shape == frames.shape and back.dtype == np.uint8
    # MJPG is lossy; it still keeps the picture.
    assert np.abs(back.astype(int) - frames).mean() < 8
    with pytest.raises(FileNotFoundError):
        video_io.VideoReader(str(tmp_path / "missing.mp4"))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        video_io.VideoReader(str(tmp_path / "empty"))
