"""The port's real-footage bank (train/data.py) and its loop plumbing:
mirrors of the bank and CLI cases of tests/test_train_data.py."""

import numpy as np
import cv2
import pytest
import torch

from dvsg_tpu.train import data as jdata
from dvsg_tpu_torch import cli
from dvsg_tpu_torch.config import ModelConfig, TrainConfig
from dvsg_tpu_torch.train import loop
from dvsg_tpu_torch.train.data import (_crop_resize, build_image_bank,
                                       build_image_bank_multi,
                                       iter_sampled_frames)
from dvsg_tpu_torch.utils import checkpoint as ckpt

MCFG = ModelConfig(window=3, model_size=(32, 32), grid_size=(8, 8),
                   base_features=8, blocks_per_level=1, max_offset=0.15)
TCFG = TrainConfig(model=MCFG, batch_size=4, steps=10, warmup_steps=2,
                   learning_rate=1e-3, checkpoint_every=0)

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small convolutions backward on many intra-op threads, in several
    test workers at once, oversubscribe the cores (minutes for one test);
    one thread is as fast alone and steady under load."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.fixture
def frame_dir(tmp_path):
    d = tmp_path / "frames"
    d.mkdir()
    rng = np.random.default_rng(0)
    for i in range(5):
        img = rng.integers(0, 256, (48, 64, 3), np.uint8)
        cv2.imwrite(str(d / f"frame{i}.png"), img)
    return str(d)


def test_bank_shape_dtype_range(frame_dir):
    bank = build_image_bank(frame_dir, (32, 32), num_images=7, seed=1)
    assert bank.shape == (7, 32, 32, 3)
    assert bank.dtype == np.float32
    assert bank.min() >= 0.0 and bank.max() <= 1.0


def test_bank_equals_the_reference_bank(frame_dir):
    """The module is a copy: same seed, same bank, byte for byte."""
    ours = build_image_bank_multi([frame_dir, frame_dir], (32, 32),
                                  num_images=9, seed=3)
    want = jdata.build_image_bank_multi([frame_dir, frame_dir], (32, 32),
                                        num_images=9, seed=3)
    assert np.array_equal(ours, want)


def test_bank_more_images_than_frames(frame_dir):
    bank = build_image_bank(frame_dir, (32, 32), num_images=12)
    assert bank.shape[0] == 12
    # Crops are independent even when frames repeat.
    assert not np.array_equal(bank[0], bank[-1])


def test_bank_source_smaller_than_model(tmp_path):
    d = tmp_path / "small"
    d.mkdir()
    cv2.imwrite(str(d / "f0.png"), np.full((8, 10, 3), 128, np.uint8))
    bank = build_image_bank(str(d), (32, 32), num_images=2)
    assert bank.shape == (2, 32, 32, 3)


def test_bank_multi_split(frame_dir, tmp_path):
    d2 = tmp_path / "frames2"
    d2.mkdir()
    cv2.imwrite(str(d2 / "f0.png"), np.zeros((40, 40, 3), np.uint8))
    bank = build_image_bank_multi([frame_dir, str(d2)], (32, 32),
                                  num_images=5)
    assert bank.shape[0] == 5
    # Second clip's images are all-black; first clip's are noise.
    assert bank[-1].max() == 0.0 and bank[0].max() > 0.0


def test_bank_empty_inputs_raise(tmp_path):
    with pytest.raises(ValueError):
        build_image_bank_multi([], (32, 32))
    d = tmp_path / "empty"
    d.mkdir()
    (d / "x.png").write_bytes(b"")  # undecodable
    with pytest.raises((ValueError, RuntimeError, OSError)):
        build_image_bank(str(d), (32, 32), num_images=2)


def test_iter_sampled_frames_counts(frame_dir):
    got = list(iter_sampled_frames(frame_dir, 8))
    assert sum(c for _, c in got) == 8 and len(got) == 5
    assert got[0][0].shape == (48, 64, 3) and got[0][0].dtype == np.uint8


def test_small_source_keeps_diversity_and_aspect():
    rng = np.random.default_rng(0)
    frame = np.zeros((24, 64, 3), np.uint8)
    frame[:, ::2] = 255  # vertical stripes: squashing would alias
    crops = [_crop_resize(frame, (32, 32), rng) for _ in range(8)]
    assert all(c.shape == (32, 32, 3) for c in crops)
    assert any(not np.array_equal(crops[0], c) for c in crops[1:])


def test_stills_come_from_bank():
    """A constant-color bank must produce constant-color base images
    (modulo flips), proving the bank path is actually used."""
    bank = torch.full((3, 32, 32, 3), 0.25)
    stills = loop._draw_stills(_gen(0), TCFG, bank, "cpu")
    assert stills.shape == (4, 32, 32, 3)
    torch.testing.assert_close(stills, torch.full_like(stills, 0.25))


def test_bank_draws_are_flipped_members():
    rng = np.random.default_rng(1)
    bank = torch.from_numpy(rng.random((3, 32, 32, 3), dtype=np.float32))
    cfg = TrainConfig(model=MCFG, batch_size=32)
    stills = loop._draw_stills(_gen(1), cfg, bank, "cpu")
    variants = [v for b in bank
                for v in (b, b.flip(0), b.flip(1), b.flip(0).flip(1))]
    hits = [next(i for i, v in enumerate(variants) if torch.equal(s, v))
            for s in stills]
    assert len(set(hits)) > 4          # several members, several flips


def test_train_step_with_bank():
    rng = np.random.default_rng(2)
    bank = torch.from_numpy(rng.random((5, 32, 32, 3), dtype=np.float32))
    state = loop.init_state(TCFG, _gen(0), device="cpu")
    for i in range(3):
        aux = loop.train_step(state, _gen(i), TCFG, bank)
    assert np.isfinite(float(aux["total"]))
    assert state.step == 3


def test_train_entry_accepts_bank():
    rng = np.random.default_rng(3)
    bank = rng.random((4, 32, 32, 3)).astype(np.float32)
    cfg = TrainConfig(model=MCFG, batch_size=4, steps=2, warmup_steps=1,
                      learning_rate=1e-3, checkpoint_every=0)
    state = loop.train(cfg, log_every=0, bank=bank, device="cpu")
    assert state.step == 2


def test_train_cli_with_data(frame_dir, tmp_path, capsys):
    out = str(tmp_path / "ckpt")
    args = ["--checkpoint", out, "--batch-size", "2", "--data", frame_dir,
            "--data-images", "4", "--window", "3", "--model-size", "32",
            "32", "--grid-size", "8", "8", "--platform", "cpu"]
    assert cli.train_main(args + ["--steps", "2"]) == 0
    assert ckpt.latest_step(out) == 2
    assert ckpt.latest_train_state_step(out) == 2
    assert "image bank: 4 crops" in capsys.readouterr().out
    # --resume continues the same directory to a longer schedule
    assert cli.train_main(args + ["--steps", "3", "--resume"]) == 0
    assert "resuming from step 2" in capsys.readouterr().out
    assert ckpt.latest_step(out) == 3


def test_train_cli_resume_rejects_other_model(tmp_path, capsys):
    out = str(tmp_path / "ckpt")
    ckpt.save_checkpoint(out, loop.init_state(
        TCFG, _gen(0), device="cpu").params, MCFG, step=1)
    rc = cli.train_main(["--checkpoint", out, "--steps", "2", "--resume",
                         "--window", "5", "--model-size", "32", "32",
                         "--grid-size", "8", "8", "--platform", "cpu"])
    assert rc == 2 and "mismatch" in capsys.readouterr().err
    assert cli.train_main(["--checkpoint", out, "--dtype", "bfloat16",
                           "--platform", "cpu"]) == 2
