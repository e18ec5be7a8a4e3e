"""``chip_smoke.py`` phase 13 (the reference's argv and ``predict_grid``)
on the CPU at a small size, as the card runs it at 1280x720."""

import pytest
import torch

import chip_smoke


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_phase13_at_a_small_size(tmp_path):
    """``chip_smoke.py`` phase 13 on the CPU at 72x128 and 17 frames: (a)
    ``predict_grid`` at both presets' full width, (b) the repaired argv
    through ``cli.main`` (``--platform cpu``: no B1 launch is counted)."""
    cpu = torch.device("cpu")
    grid = chip_smoke.p13_predict_grid(0, cpu, height=72, width=128)
    assert set(grid) == {"fast", "quality"}
    assert all(r["max_abs_vs_cpu"] == 0.0 for r in grid.values())
    launches, res = chip_smoke.p13_argv(0, cpu, str(tmp_path), height=72,
                                        width=128, frames=17)
    assert launches == 0 and len(res) == 6
    assert res["eval --warp-impl pallas"]["rc"] == 2
