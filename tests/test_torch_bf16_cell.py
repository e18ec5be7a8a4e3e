"""The benchmark cell ``train-quality-b32-bf16`` on the CPU at a small
size: the port's bf16 training step against the plain float32 reference
(``portbench/reference/train.py``), the control below bf16's precision
(``portbench/reference/lowp.py``), the driver's dtype folding, the split
of a step's FLOPs by precision, the cell's four per-layer metrics on a
hand-made trace, and the two spans the bf16 path opens.

The weights are seeded random ones with a nonzero ``head_out``, so that
every gradient flows. A bf16 step is held to the f32 reference by
tolerances that sit between its readings and the control's: bf16 keeps 8
significant bits and the port rounds at every op of the trunk, forward
and backward (``models/motion_cnn.py``); the control keeps 5 and rounds
each conv, GroupNorm and GELU output and its gradient once.
"""

import contextlib
import dataclasses
import os
import statistics
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from dvsg_tpu_torch.config import ModelConfig, TrainConfig  # noqa: E402
from dvsg_tpu_torch.models import motion_cnn  # noqa: E402
from dvsg_tpu_torch.train import loop  # noqa: E402
from dvsg_tpu_torch.utils import metrics  # noqa: E402
from dvsg_tpu_torch.utils.checkpoint import export_npz  # noqa: E402
from portbench import generate, harness, tracing  # noqa: E402
from portbench.metrics import _bf16, _work  # noqa: E402
from portbench.reference import cnn, lowp  # noqa: E402
from portbench.reference import train as ref_train  # noqa: E402
# a raw profiler event as tracing.Trace reads one
from portbench.tests.test_portbench_drivers import _Ev  # noqa: E402

SMALL = ModelConfig(window=3, model_size=(64, 64), base_features=16,
                    levels=3, blocks_per_level=1, grid_size=(8, 8),
                    corr_radius=1)
RECIPE = {"batch_size": 2, "learning_rate": 3e-4, "steps": 4000,
          "warmup_steps": 100, "weight_decay": 1e-5,
          "loss_weights": {"pixel": 1.0, "offset": 10.0, "smooth": 0.1,
                           "reg": 0.001}}
SEEDS = (0, 1, 2, 3)
# Tolerances on the first step over SEEDS, with the readings measured on
# an x86 CPU in brackets. The median over parameters and seeds of a
# parameter's relative gradient error (bf16 0.0102, the control 0.0414):
# bf16's 1 % is its 0.2 % unit roundoff carried through about ten rounded
# ops a layer, forward and backward; the control's 3 % roundoff, at three
# points a layer, gives four times that. The median over seeds of the
# loss's relative gap (bf16 8.3e-4, the control 5.4e-3). Each tolerance
# sits at least twice from both readings.
GRAD_TOL = 0.02
LOSS_TOL = 2e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A float32 checkpoint of SMALL: the port's initializer, then every
    bias and ``head_out`` drawn nonzero."""
    gen = torch.Generator().manual_seed(19)
    params = motion_cnn.init_params(SMALL, gen)
    for name, p in params.items():
        if name.endswith(".bias") or name == "head_out.weight":
            params[name] = 0.02 * torch.randn(p.shape, generator=gen)
    path = str(tmp_path_factory.mktemp("bf16cell") / "small.npz")
    export_npz(path, params, SMALL)
    return path


def _reference(path, seed, control=False):
    params, cfg = cnn.load_npz(path)
    with lowp.rounded_trunk() if control else contextlib.nullcontext():
        terms, grads = ref_train.gradient(params, cfg, RECIPE,
                                          generate.step_generator(seed, 0))
    return terms["total"], {cnn.torch_name(k): cnn.torch_layout(k, g)
                            for k, g in grads.items()}


def _port_bf16(path, seed):
    """The loss and gradients of the port's first bf16 ``train_step``."""
    from dvsg_tpu_torch.utils.checkpoint import load_npz
    params, mcfg = load_npz(path)
    tcfg = TrainConfig(model=dataclasses.replace(mcfg, dtype="bfloat16"),
                       batch_size=RECIPE["batch_size"],
                       learning_rate=RECIPE["learning_rate"],
                       weight_decay=RECIPE["weight_decay"],
                       steps=RECIPE["steps"],
                       warmup_steps=RECIPE["warmup_steps"],
                       checkpoint_every=0)
    state = loop.build_state(tcfg, params, "cpu")
    aux = loop.train_step(state, generate.step_generator(seed, 0), tcfg)
    return float(aux["total"]), {n: p.grad for n, p in
                                 state.model.named_parameters()}


@pytest.fixture(scope="module")
def readings(weights):
    """Per variant: (median loss gap over SEEDS, median over parameters and
    SEEDS of the relative gradient error) against the f32 reference."""
    out = {"program": ([], []), "control": ([], [])}
    for seed in SEEDS:
        loss, grads = _reference(weights, seed)
        for name, (l, g) in (("program", _port_bf16(weights, seed)),
                             ("control", _reference(weights, seed, True))):
            out[name][0].append(abs(l - loss) / abs(loss))
            out[name][1].extend(float((g[k] - r).norm() / r.norm())
                                for k, r in grads.items())
    return {k: (statistics.median(a), statistics.median(b))
            for k, (a, b) in out.items()}


@pytest.mark.parametrize("variant,within", [("program", True),
                                            ("control", False)])
def test_bf16_step_against_the_f32_reference(readings, variant, within):
    loss_gap, grad_err = readings[variant]
    print(f"{variant}: loss gap {loss_gap:.3g}, gradient error "
          f"{grad_err:.3g}")
    if within:
        assert loss_gap < LOSS_TOL and grad_err < GRAD_TOL
    else:
        assert loss_gap > LOSS_TOL and grad_err > GRAD_TOL


def test_the_control_rounds_to_four_mantissa_bits():
    x = torch.tensor([1.0, 1.03125, 1.09375, -1.09375, 3.1415927, 0.0])
    assert lowp.round_mantissa(x).tolist() == [1.0, 1.0, 1.125, -1.125,
                                               3.125, 0.0]
    y = torch.randn(4096) * 100
    assert torch.equal(lowp.round_mantissa(y, 7),
                       y.to(torch.bfloat16).float())
    plain = cnn.encode
    with lowp.rounded_trunk():
        assert cnn.encode is not plain
    assert cnn.encode is plain


def _driver():
    return harness.load_module("drivers", "train_dtype")


def test_the_driver_folds_the_dtype_and_refuses_other_differences():
    record = {"arch": "corr", "base_features": 32, "blocks_per_level": 2,
              "channels": 3, "corr_radius": 3, "dtype": "float32",
              "grid_size": [16, 16], "levels": 4, "max_offset": 0.2,
              "model_size": [256, 256], "window": 5}
    fold = _driver().fold
    got = fold(record, dict(record, dtype="bfloat16"))
    assert got.dtype == "bfloat16"
    assert dataclasses.replace(got, dtype="float32") == ModelConfig(
        **dict(record, grid_size=(16, 16), model_size=(256, 256)))
    assert fold(record, record).dtype == "float32"
    for key, value in (("window", 3), ("base_features", 16),
                       ("model_size", [128, 128])):
        with pytest.raises(ValueError, match="more than dtype"):
            fold(record, dict(record, dtype="bfloat16", **{key: value}))


def test_the_cells_configuration_folds_onto_its_checkpoint():
    spec = harness.load_spec("train-quality-b32-bf16")
    drv = _driver()
    record = drv.checkpoint_record(os.path.join(
        ROOT, spec.config["checkpoint"]))
    assert record["dtype"] == "float32"
    assert drv.fold(record, spec.config["model"]).dtype == "bfloat16"
    assert spec.traffic["kind"] == "train_dtype"


MODELS = {
    "quality": {"arch": "corr", "base_features": 32, "blocks_per_level": 2,
                "channels": 3, "corr_radius": 3, "grid_size": [16, 16],
                "model_size": [256, 256], "window": 5},
    "fast": {"arch": "corr", "base_features": 32, "blocks_per_level": 1,
             "channels": 3, "corr_radius": 3, "grid_size": [16, 16],
             "model_size": [128, 128], "window": 5},
    "small": {"arch": "corr", "base_features": 16, "blocks_per_level": 1,
              "channels": 3, "corr_radius": 1, "grid_size": [8, 8],
              "model_size": [64, 64], "window": 3},
}


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("batch", [1, 8, 32])
def test_the_split_by_precision_adds_up_to_the_step(model, batch):
    split = _bf16.step_flops(MODELS[model], batch)
    assert split["bf16"] > 0 and split["f32"] > 0
    assert split["bf16"] + split["f32"] == _work.train_step_flops(
        MODELS[model], batch)


def test_the_quality_step_is_mostly_bf16_convolutions():
    split = _bf16.step_flops(MODELS["quality"], 32)
    assert sum(split.values()) / 1e12 == pytest.approx(10.57, abs=0.01)
    assert split["bf16"] / sum(split.values()) == pytest.approx(0.994,
                                                                 abs=1e-3)


BF16_CONV = "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwc"


def _bf16_trace():
    """A 1 ms window of two steps. Thread 1 (forward): a bf16 conv (its
    kernel 100 us and a 20 us layout transpose), an f32 head conv (50 us),
    a ``bf16_round`` span launching a 30 us kernel. Thread 2 (autograd):
    a ``bf16_round`` span (a 40 us kernel), a conv backward (a 60 us bf16
    kernel), a ``corr_bwd`` span launching two kernels of 5 us."""
    return tracing.Trace([
        _Ev("aten::convolution", "cpu_op", 0, 100_000, cid=1),
        _Ev(BF16_CONV, "kernel", 10_000, 100_000, link=1),
        _Ev("void cudnn::engines_precompiled::nchwToNhwcKernel"
            "<__nv_bfloat16, __nv_bfloat16, float>", "kernel",
            115_000, 20_000, link=1),
        _Ev("aten::convolution", "cpu_op", 120_000, 20_000, cid=2),
        _Ev("sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs",
            "kernel", 140_000, 50_000, link=2),
        _Ev("dvsg.bf16_round", "cpu_op", 200_000, 50_000, cid=3),
        _Ev("aten::mul", "cpu_op", 210_000, 10_000, cid=4),
        _Ev("mul_kernel", "kernel", 220_000, 30_000, link=4),
        _Ev("dvsg.bf16_round", "cpu_op", 300_000, 50_000, cid=5, tid=2),
        _Ev("aten::add", "cpu_op", 310_000, 10_000, cid=6, tid=2),
        _Ev("add_kernel", "kernel", 320_000, 40_000, link=6),
        _Ev("aten::convolution_backward", "cpu_op", 400_000, 50_000, cid=7,
            tid=2),
        _Ev("sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwc",
            "kernel", 410_000, 60_000, link=7),
        _Ev("dvsg.corr_bwd", "cpu_op", 500_000, 100_000, cid=8, tid=2),
        _Ev("aten::mul", "cpu_op", 510_000, 10_000, cid=9, tid=2),
        _Ev("corr_kernel", "kernel", 520_000, 5_000, link=9),
        _Ev("aten::add_", "cpu_op", 530_000, 10_000, cid=10, tid=2),
        _Ev("corr_kernel", "kernel", 540_000, 5_000, link=10),
    ], 0, 1_000_000)


def _run(trace, model=MODELS["quality"], steps=2, batch=32):
    spec = harness.Spec(cell={}, config={"model": model}, traffic={},
                        limits={}, end_to_end=[], per_layer=[])
    return harness.Run(spec=spec, rank=0, world=1, setup_s=0.0,
                       window_s=1e-3, work={"steps": steps,
                                            "batch": batch,
                                            "rank_batch": batch},
                       stamps={}, stages={}, checks={}, attempted=steps,
                       failed=0, memory_peak_bytes=0, trace=trace)


def _read(name, run):
    return harness.load_module("metrics", name).read(run)


def test_the_span_metrics_read_the_kernels_inside_their_spans():
    run = _run(_bf16_trace())
    # 30 + 40 us of kernels in bf16_round, on both threads, over 2 steps
    assert _read("bf16_round_ms_per_step", run) == pytest.approx(0.035)
    assert _read("corr_bwd_ms_per_step", run) == pytest.approx(0.005)


def test_the_conv_roofline_reads_the_bf16_kernels_under_convolution():
    run = _run(_bf16_trace(), model=MODELS["small"], batch=1)
    # 100 + 20 + 60 us of bf16 kernels; the f32 head conv is left out
    flops = 2 * _bf16.step_flops(MODELS["small"], 1)["bf16"]
    want = 100.0 * flops / _bf16.FLOPS_BF16 / 180e-6
    assert _read("bf16_conv_roofline", run) == pytest.approx(want)


def test_the_mfu_weighs_each_part_by_its_peak():
    run = _run(_bf16_trace(), model=MODELS["small"], batch=1)
    split = _bf16.step_flops(MODELS["small"], 1)
    need = (split["bf16"] / 989e12
            + split["f32"] / _work.PEAKS["flops_f32"])
    assert _read("mfu_pct.train_bf16", run) == pytest.approx(
        100.0 * 2 * need / 1e-3)


@pytest.mark.parametrize("name", ["bf16_round_ms_per_step",
                                  "corr_bwd_ms_per_step",
                                  "bf16_conv_roofline",
                                  "mfu_pct.train_bf16"])
def test_an_untraced_run_or_a_program_without_spans_reads_nothing(name):
    assert _read(name, _run(None)) is None
    no_spans = tracing.Trace([
        _Ev("aten::mm", "cpu_op", 0, 20_000, cid=1),
        _Ev("gemm_kernel", "kernel", 10_000, 100_000, link=1)],
        0, 1_000_000)
    if name.endswith("ms_per_step") or name == "bf16_conv_roofline":
        assert _read(name, _run(no_spans)) is None


def _bf16_step():
    cfg = dataclasses.replace(SMALL, dtype="bfloat16", base_features=8,
                              model_size=(32, 32), grid_size=(8, 8),
                              levels=2)
    model = motion_cnn.MotionEstimator(cfg)
    model.load_state_dict(motion_cnn.init_params(
        cfg, torch.Generator().manual_seed(0)))
    torch.nn.init.normal_(model.head_out.weight, std=0.02)
    windows = torch.rand(2, 32, 32, 3 * cfg.window,
                         generator=torch.Generator().manual_seed(1))
    motion_cnn.predict_offsets(model, windows).square().sum().backward()


def test_without_a_profiler_the_spans_are_no_ops():
    for name in ("bf16_round", "corr_bwd"):
        assert metrics.span(name) is metrics._NO_SPAN


def test_under_a_profiler_the_spans_are_host_ops():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _bf16_step()
    events = list(prof.profiler.kineto_results.events())
    for name in ("dvsg.bf16_round", "dvsg.corr_bwd"):
        found = [e for e in events if e.name() == name]
        assert found, name
        for e in found:
            assert e.device_type() == torch.autograd.DeviceType.CPU
            assert not e.is_user_annotation()
    # the forward's and the backward's rounding passes, and one
    # correlation backward a step
    assert len([e for e in events if e.name() == "dvsg.corr_bwd"]) == 1
