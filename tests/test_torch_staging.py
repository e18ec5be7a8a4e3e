"""The port's host staging extension (native/staging.cpp through
utils/staging.py): the counterparts of tests/test_staging.py, the
extension byte-equal to the plain numpy swap and to the JAX package's
``bgr_to_rgb`` on the same frames, and a failed build that raises."""

import os
import threading

import numpy as np
import pytest

from dvsg_tpu.utils import staging as jstaging
from dvsg_tpu_torch.native import build as native_build
from dvsg_tpu_torch.utils import staging


@pytest.fixture(scope="module")
def src():
    rng = np.random.default_rng(0)
    return rng.integers(0, 256, (4, 64, 96, 3), dtype=np.uint8)


def test_native_module_builds():
    mod = staging.native()
    assert mod.__name__ == "_dvsg_torch_native"
    assert os.path.dirname(mod.__file__) == native_build.BUILD_DIR
    assert mod.pool_size() >= 1


def test_bgr_to_rgb_matches_numpy(src):
    np.testing.assert_array_equal(staging.bgr_to_rgb(src), src[..., ::-1])


@pytest.mark.parametrize("shape", [(4, 64, 96, 3), (2, 37, 51, 3),
                                   (1, 720, 1280, 3), (5, 3)])
def test_extension_equals_plain_and_reference(shape):
    """Byte-equal to the plain swap and to dvsg_tpu's ``bgr_to_rgb`` on the
    same seeded frames, at shapes that split into uneven pool tasks."""
    frames = np.random.default_rng(len(shape)).integers(
        0, 256, shape, dtype=np.uint8)
    got = staging.bgr_to_rgb(frames)
    np.testing.assert_array_equal(got, staging.bgr_to_rgb_plain(frames))
    np.testing.assert_array_equal(got, jstaging.bgr_to_rgb(frames))


def test_bgr_to_rgb_into_preallocated(src):
    out = np.empty_like(src[0])
    ret = staging.bgr_to_rgb(src[0], out)
    assert ret is out
    np.testing.assert_array_equal(out, src[0][..., ::-1])


def test_stack_frames(src):
    out = staging.stack_frames([src[i] for i in range(len(src))])
    np.testing.assert_array_equal(out, src)
    assert out.ctypes.data % 4096 == 0


def test_alloc_staging_alignment():
    buf = staging.alloc_staging((3, 5, 7, 3), alignment=4096)
    assert buf.ctypes.data % 4096 == 0
    assert buf.shape == (3, 5, 7, 3)
    buf[:] = 1  # writable


def test_staging_ring_round_robin():
    ring = staging.StagingRing(2, (2, 4, 4, 3))
    a, b, c = ring.next_slot(), ring.next_slot(), ring.next_slot()
    assert a is c and a is not b


def test_reader_uses_staging_buffer(tmp_path):
    pytest.importorskip("cv2")
    from dvsg_tpu_torch.utils import video_io
    frames = np.random.default_rng(1).integers(0, 256, (5, 32, 48, 3),
                                               dtype=np.uint8)
    d = str(tmp_path / "f")
    with video_io.VideoWriter(d, 48, 32) as w:
        w.write_batch(frames)
    ring = staging.StagingRing(2, (3, 32, 48, 3))
    with video_io.VideoReader(d) as r:
        slot = ring.next_slot()
        got = r.read_batch(3, out=slot)
        assert got.base is slot.base or got.base is slot  # view into slot
        np.testing.assert_array_equal(got, frames[:3])


def test_concurrent_callers_thread_safe():
    """Decode threads call the pool at once: interleaved submissions must
    neither deadlock nor corrupt."""
    src = np.random.default_rng(2).integers(0, 256, (8, 64, 96, 3),
                                            dtype=np.uint8)
    errors = []

    def worker(i):
        try:
            for _ in range(50):
                out = staging.bgr_to_rgb(src[i % len(src)])
                if not np.array_equal(out, src[i % len(src)][..., ::-1]):
                    raise AssertionError("wrong bytes")
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive(), "native pool deadlocked"
    assert not errors


def test_bgr_to_rgb_rejects_noncontiguous_out():
    """A non-contiguous out would receive nothing (the swap would write
    into reshape(-1)'s copy): it must raise instead."""
    src = np.arange(2 * 4 * 3, dtype=np.uint8).reshape(2, 4, 3)
    backing = np.empty((2, 8, 3), np.uint8)
    with pytest.raises(ValueError, match="contiguous"):
        staging.bgr_to_rgb(src, out=backing[:, ::2, :])


def test_failed_build_raises(tmp_path, monkeypatch):
    """No silent numpy fallback: a compiler that fails, in a fresh build
    directory, raises with what it printed."""
    monkeypatch.setattr(native_build, "BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setattr(staging, "_native", None)
    monkeypatch.setenv("CXX", "/bin/false")
    with pytest.raises(RuntimeError, match="building the staging extension "
                                           "failed"):
        staging.bgr_to_rgb(np.zeros((2, 2, 3), np.uint8))
    assert not os.listdir(tmp_path / "b")         # no half-written library
