"""The control and the faults on the cards, at the cells' own sizes: the
limits of ``correct`` hold the program's readings and refuse the
control's (the plain reference with TF32 on, in the program's place) and
every planted fault's, the four-card cell's exchange left out among them.
Marked ``cuda``; on a machine with the cards a cell asks for:

    python -m pytest -p no:cacheprovider \
        portbench/tests/test_portbench_control.py
"""

import pytest
import torch

from portbench import harness

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("cell", ["stream-quality-720p", "train-fast-b32",
                                  "dptrain-quality-b32-4card"])
def test_limits_separate_program_from_control_and_faults(cell):
    harness.prepare_env()
    spec = harness.load_spec(cell)
    chips = spec.cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} CUDA card(s): the control is TF32, "
                    "which the CPU does not have, and the port's kernels "
                    "have no CPU mode")
    (rec,) = harness.run_sweep(spec, [2 ** 31 + 101], "cuda")
    limit = {k: v["limit"] for k, v in spec.limits.items()}
    assert all(rec["program"][k] <= limit[k] for k in limit), rec
    variants = [v for v, numbers in rec.items()
                if isinstance(numbers, dict) and v != "program"]
    assert "control" in variants
    if spec.cell["chips"] > 1:
        assert "no_exchange" in variants
    for variant in variants:
        assert any(rec[variant][k] > limit[k] for k in limit), (variant, rec)
