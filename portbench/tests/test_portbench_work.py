"""The operation and byte counts against FlopCounterMode over the plain
reference, and against the port's kernel table (PERF.md) at its shapes."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import TINY_MODEL, tiny_checkpoint
from portbench.metrics import _work
from portbench.reference import cnn, stream
from portbench.reference import train as ref_train

FAST = dict(TINY_MODEL, model_size=[128, 128], base_features=32,
            blocks_per_level=1, grid_size=[16, 16], window=5, corr_radius=3)
QUALITY = dict(FAST, model_size=[256, 256], blocks_per_level=2)
TRAIN = {"batch_size": 2, "learning_rate": 1e-3, "steps": 10,
         "warmup_steps": 1, "weight_decay": 1e-5,
         "loss_weights": {"pixel": 1.0, "offset": 10.0, "smooth": 0.1,
                          "reg": 0.001}}


@pytest.fixture
def params(tmp_path):
    p, _ = cnn.load_npz(tiny_checkpoint(str(tmp_path / "t.npz")))
    return p


def test_chunk_flops_match_the_counter(params):
    torch.manual_seed(0)
    frames = torch.randint(0, 256, (4, 24, 40, 3), dtype=torch.uint8)
    with FlopCounterMode(display=False) as fc:
        stream.chunk(params, TINY_MODEL, frames, None)
    assert fc.get_total_flops() == _work.chunk_flops(TINY_MODEL, 4, 24, 40)


def test_train_step_flops_match_the_counter(params):
    gen = torch.Generator().manual_seed(3)
    with FlopCounterMode(display=False) as fc:
        ref_train.gradient(params, TINY_MODEL, TRAIN, gen)
    assert fc.get_total_flops() == _work.train_step_flops(TINY_MODEL, 2)


@pytest.mark.parametrize("model,gflop", [(FAST, 357.6), (QUALITY, 2642.0)])
def test_train_step_flops_at_the_presets(model, gflop):
    """A count of the port's own batch-8 step with FlopCounterMode."""
    assert _work.train_step_flops(model, 8) / 1e9 == pytest.approx(
        gflop, rel=1e-3)


def test_bytes_match_the_kernel_table():
    # B2, B3 forward and backward at the table's shapes (f32, 256 x 256)
    assert _work.warp_f32_bytes(64, 256, 256, 3, 256, 256) == 134_217_728
    assert _work.warp_f32_bytes(16, 256, 256, 3, 256, 256) == 33_554_432
    assert _work.warp_grad_bytes(16, 256, 256, 3, 256, 256) == 41_943_040
    # B1 (16 720p frames, a 16 x 16 grid): frames in and out, the coarse
    # offsets in
    assert _work.b1_bytes(16, 720, 1280, 3, 16, 16) / 1e6 == pytest.approx(
        88.5, abs=0.05)
    # a batch-8 training step's three warps are the table's B2 + B3
    assert _work.train_warp_bytes(QUALITY, 8) == (
        134_217_728 + 33_554_432 + 41_943_040)
