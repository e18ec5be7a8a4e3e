"""The port's ``VideoReader`` as the reference's: ``.shape`` and iteration
(``for frame in reader``) over a frame directory and over an mp4, each
against the reference's reader on the same file and against ``read()``."""

import os

import numpy as np
import pytest

from dvsg_tpu.utils import video_io as jvideo_io
from dvsg_tpu_torch.utils import video_io


def _frames(n=5, h=36, w=52, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3),
                                                dtype=np.uint8)


def _write(path, frames):
    with video_io.VideoWriter(path, frames.shape[2], frames.shape[1],
                              fps=24.0) as w:
        w.write_batch(frames)
    return path


@pytest.fixture(params=["frame_dir", "mp4"])
def clip(request, tmp_path):
    """A written clip (path, frames written) of either kind."""
    frames = _frames()
    if request.param == "frame_dir":
        return _write(str(tmp_path / "frames"), frames), frames
    path = _write(str(tmp_path / "clip.mp4"), frames)
    with video_io.VideoReader(path) as r:
        if r.read() is None:
            pytest.skip("this OpenCV build writes no mp4 it can read back")
    return path, frames


def test_shape_is_the_references(clip):
    path, frames = clip
    with video_io.VideoReader(path) as r:
        ref = jvideo_io.VideoReader(path)
        try:
            assert r.shape == ref.shape == frames.shape[1:3]
        finally:
            ref.close()
        assert r.shape == (r.height, r.width)


def test_iteration_yields_what_read_does(clip):
    """``list(reader)`` holds every frame of the clip, byte-equal to the
    reference's iteration and to ``read()`` on a fresh reader, then stops
    (again on a second ``next``)."""
    path, frames = clip
    with video_io.VideoReader(path) as r:
        assert iter(r) is r
        got = list(r)
        with pytest.raises(StopIteration):
            next(r)
    ref = jvideo_io.VideoReader(path)
    try:
        want = list(ref)
    finally:
        ref.close()
    with video_io.VideoReader(path) as r:
        read = []
        while (f := r.read()) is not None:
            read.append(f)
    assert len(got) == len(want) == len(read) == len(frames)
    for g, w, d in zip(got, want, read):
        assert g.dtype == np.uint8 and g.shape == frames.shape[1:]
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, d)
    if os.path.isdir(path):                  # lossless: the frames written
        np.testing.assert_array_equal(np.stack(got), frames)


def test_iteration_goes_on_from_read_batch(tmp_path):
    """A reader part-read by ``read_batch`` iterates over what is left."""
    frames = _frames(7, seed=1)
    path = _write(str(tmp_path / "frames"), frames)
    with video_io.VideoReader(path) as r:
        np.testing.assert_array_equal(r.read_batch(3), frames[:3])
        np.testing.assert_array_equal(np.stack(list(r)), frames[3:])
