"""The port's evaluation harness (train/eval.py) and eval CLI: mirrors of
tests/test_eval.py, and smoothed_targets against the JAX package."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dvsg_tpu.train import eval as jeval
from dvsg_tpu_torch import cli
from dvsg_tpu_torch.config import ModelConfig, StabilizeConfig
from dvsg_tpu_torch.models import motion_cnn
from dvsg_tpu_torch.ops import grid as grid_ops
from dvsg_tpu_torch.ops.warp_ref import bilinear_warp
from dvsg_tpu_torch.pipeline.stabilize import Stabilizer
from dvsg_tpu_torch.train import eval as eval_lib
from dvsg_tpu_torch.train import synthetic
from dvsg_tpu_torch.utils.metrics import psnr

MCFG = ModelConfig(window=3, model_size=(32, 32), grid_size=(8, 8),
                   base_features=8, blocks_per_level=1)
CFG = StabilizeConfig(model=MCFG, chunk_frames=8)
SMALL = ["--window", "3", "--model-size", "32", "32", "--grid-size", "8",
         "8", "--platform", "cpu"]

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


def _identity_stab():
    return Stabilizer(CFG, motion_cnn.init_params(MCFG, _gen(0)),
                      device="cpu")


@pytest.mark.parametrize("window", [1, 3, 5])
def test_smoothed_targets_match_reference(window):
    rng = np.random.default_rng(window)
    still = rng.random((24, 32, 3), dtype=np.float32)
    path = (rng.uniform(-1, 1, (7, 5)) * [0.08, 0.08, 0.05, 0.02, 0.02]
            ).astype(np.float32)
    want = jeval.smoothed_targets(jnp.asarray(still), jnp.asarray(path),
                                  window)
    got = eval_lib.smoothed_targets(torch.from_numpy(still),
                                    torch.from_numpy(path), window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_smoothed_targets_match_direct():
    frames, still, path = synthetic.synthetic_clip(_gen(0), 6, 32, 32)
    targets = eval_lib.smoothed_targets(still, path, window=3)
    assert targets.shape == (6, 32, 32, 3)
    # frame 0's window is replicate-padded -> mean pose == pose 0 ->
    # target 0 == the unstable frame 0 itself
    np.testing.assert_allclose(targets[0].numpy(), frames[0].numpy(),
                               atol=1e-5)


def test_identity_model_metrics_sane():
    m = eval_lib.evaluate_synthetic(_identity_stab(), _gen(1), 12, 48, 64)
    # identity model: output == input, so both PSNRs match and the
    # stability gain is ~1
    assert abs(m["psnr_vs_target"] - m["psnr_identity"]) < 0.5
    assert 0.9 < m["stability_gain"] < 1.1
    assert m["steadiness_in"] > 0 and m["frames"] == 12.0


def test_eval_on_user_still():
    stab = _identity_stab()
    rng = np.random.default_rng(5)
    still = rng.random((48, 64, 3)).astype(np.float32)
    m = eval_lib.evaluate_synthetic(stab, _gen(3), 10, 48, 64, still=still)
    assert abs(m["psnr_vs_target"] - m["psnr_identity"]) < 0.5
    assert m["steadiness_in"] > 0  # jitter actually moved the user image
    with pytest.raises(ValueError):
        eval_lib.evaluate_synthetic(stab, _gen(3), 10, 48, 64,
                                    still=still[:20])


def test_track_metrics_reported():
    m = eval_lib.evaluate_synthetic(_identity_stab(), _gen(2), 8, 48, 64,
                                    track_metrics=True)
    assert {"cropping_ratio", "distortion_value",
            "tracked_frames"} <= set(m)


def test_oracle_offsets_beat_identity():
    """Feeding the ground-truth stabilizing warp through the warp must beat
    the identity baseline by a wide margin — validates the metric
    direction before any model training."""
    frames, still, path = synthetic.synthetic_clip(_gen(2), 10, 64, 64)
    window = 3
    padded = torch.cat([path[:1].expand(window - 1, -1), path])
    outs = []
    for t in range(10):
        theta = synthetic.stabilizing_theta(padded[t:t + window])
        g = grid_ops.homography_grid(theta, 64, 64)
        outs.append(bilinear_warp(frames[t], g))
    out = torch.stack(outs).numpy()
    targets = eval_lib.smoothed_targets(still, path, window).numpy()
    inner = (slice(None), slice(8, -8), slice(8, -8))
    p_oracle = psnr(out[inner], targets[inner])
    p_identity = psnr(frames.numpy()[inner], targets[inner])
    assert p_oracle > p_identity + 5, (p_oracle, p_identity)
    assert p_oracle > 37, p_oracle


def test_eval_cli_with_stills(tmp_path):
    import cv2
    d = tmp_path / "imgs"
    d.mkdir()
    rng = np.random.default_rng(7)
    for i in range(2):
        cv2.imwrite(str(d / f"f{i}.png"),
                    rng.integers(0, 256, (40, 56, 3), np.uint8))
    out = tmp_path / "m.jsonl"
    rc = cli.eval_main([
        "--stills", str(d), "--clips", "2", "--frames", "6",
        "--size", "32", "32", "--metrics-out", str(out)] + SMALL)
    assert rc == 0 and out.exists()
    import json
    rec = json.loads(out.read_text().splitlines()[-1])
    assert rec["kind"] == "eval_synthetic" and rec["device"] == "cpu"
    assert cli.eval_main(["--stills", str(tmp_path / "nope"),
                          "--platform", "cpu"]) == 2


def test_eval_cli_on_a_trained_checkpoint_dir(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    assert cli.main(["train", "--checkpoint", ckpt, "--steps", "2",
                     "--batch-size", "2"] + SMALL) == 0
    assert cli.main(["eval", "--checkpoint", ckpt, "--clips", "1",
                     "--frames", "6", "--size", "32", "48",
                     "--platform", "cpu"]) == 0
    assert "psnr_gain_db" in capsys.readouterr().out


def test_eval_cli_default_is_the_committed_fast_model(capsys):
    rc = cli.eval_main(["--clips", "1", "--frames", "8", "--size", "96",
                        "128", "--chunk-frames", "8", "--platform", "cpu"])
    assert rc == 0
    mean = capsys.readouterr().out.splitlines()[-1]
    gain = float(mean.split("psnr_gain_db=")[1].split()[0])
    assert gain > 0          # the shipped weights stabilize


@pytest.mark.parametrize("flags", [["--path-smooth", "8"],
                                   ["--path-smooth-lag", "4"],
                                   ["--dtype", "bfloat16"],
                                   ["--preset", "fast", "--checkpoint", "x"],
                                   ["--chunk-frames", "0"]])
def test_eval_cli_refuses(flags, capsys):
    assert cli.eval_main(flags + ["--platform", "cpu"]) == 2
    assert "ERROR" in capsys.readouterr().err


def test_eval_and_train_cli_raise_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.eval_main(["--clips", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.train_main(["--checkpoint", str(tmp_path / "c"), "--steps",
                        "1"])
    assert cli.main(["bogus"]) == 2
