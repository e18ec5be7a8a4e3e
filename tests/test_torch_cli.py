"""The port's CLI on the CPU: ``stabilize`` loading a training checkpoint
directory, the reference's model, metrics and warp flags on ``stabilize``,
the configs at the package root, and ``stabilize-batch`` (mirrors of
tests/test_io_cli.py and tests/test_multiclip.py)."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import dvsg_tpu_torch
from dvsg_tpu_torch import cli, config
from dvsg_tpu_torch.config import ModelConfig, StabilizeConfig
from dvsg_tpu_torch.models import motion_cnn
from dvsg_tpu_torch.pipeline import autocrop
from dvsg_tpu_torch.pipeline.stabilize import Stabilizer
from dvsg_tpu_torch.train import synthetic
from dvsg_tpu_torch.utils import checkpoint as ckpt
from dvsg_tpu_torch.utils import video_io

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAST = os.path.join(ROOT, "checkpoints", "flagship_fast.npz")
TINY = ["--window", "3", "--model-size", "32", "32", "--grid-size", "8",
        "8"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clip(n, key=3, h=48, w=64):
    return synthetic.synthetic_clip_u8(torch.Generator().manual_seed(key),
                                       n, h, w)[0].numpy()


def _write_dir(path, frames):
    with video_io.VideoWriter(str(path), frames.shape[2],
                              frames.shape[1]) as w:
        w.write_batch(frames)
    return str(path)


def _read_dir(path):
    with video_io.VideoReader(str(path)) as r:
        return r.read_batch(1000)


def _stab(params, mcfg, **kw):
    return Stabilizer(StabilizeConfig(model=mcfg, chunk_frames=4, **kw),
                      params, device="cpu")


def test_package_root_reexports_configs():
    assert dvsg_tpu_torch.ModelConfig is config.ModelConfig
    assert dvsg_tpu_torch.StabilizeConfig is config.StabilizeConfig
    assert dvsg_tpu_torch.TrainConfig is config.TrainConfig


def test_io_threads_field_matches_reference():
    from dvsg_tpu.config import StabilizeConfig as JStabilizeConfig
    assert StabilizeConfig().io_threads == JStabilizeConfig().io_threads == 4
    cfg = config.stabilize_config_from_dict(
        {"model": {"window": 3, "model_size": [32, 32],
                   "grid_size": [8, 8]}, "io_threads": 2})
    assert cfg.io_threads == 2


def test_stabilize_loads_a_train_directory(tmp_path):
    """A checkpoint directory written by ``train`` stabilizes as its
    weights do in the library."""
    ck = str(tmp_path / "ck")
    assert cli.main(["train", "--checkpoint", ck, "--steps", "1",
                     "--batch-size", "1", "--platform", "cpu", *TINY]) == 0
    frames = _clip(6, h=32, w=40)
    src = _write_dir(tmp_path / "in", frames)
    assert cli.main(["stabilize", "--input", src, "--output",
                     str(tmp_path / "out"), "--checkpoint", ck,
                     "--chunk-frames", "4", "--platform", "cpu"]) == 0
    params, mcfg, step = ckpt.load_checkpoint(ck)
    assert step == 1
    np.testing.assert_array_equal(_read_dir(tmp_path / "out"),
                                  _stab(params, mcfg).stabilize_clip(frames))
    assert cli.main(["stabilize", "--input", src, "--output",
                     str(tmp_path / "o2"), "--checkpoint",
                     str(tmp_path / "missing"), "--platform", "cpu"]) == 2


def test_stabilize_model_flags_select_the_identity_model(tmp_path, capsys):
    frames = _clip(6, h=32, w=40)
    src = _write_dir(tmp_path / "in", frames)
    assert cli.main(["stabilize", "--input", src, "--output",
                     str(tmp_path / "out"), "--chunk-frames", "4",
                     "--platform", "cpu", "--dtype", "float32",
                     *TINY]) == 0
    assert "untrained (identity) model" in capsys.readouterr().err
    mcfg = ModelConfig(window=3, model_size=(32, 32), grid_size=(8, 8))
    params = motion_cnn.init_params(mcfg, torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(_read_dir(tmp_path / "out"),
                                  _stab(params, mcfg).stabilize_clip(frames))


def test_stabilize_metrics_out_and_warp_impl_auto(tmp_path):
    frames = _clip(6)
    src = _write_dir(tmp_path / "in", frames)
    metrics = str(tmp_path / "m.jsonl")
    assert cli.main(["stabilize", "--input", src, "--output",
                     str(tmp_path / "out"), "--chunk-frames", "4",
                     "--platform", "cpu", "--warp-impl", "auto",
                     "--metrics-out", metrics]) == 0
    with open(metrics) as f:
        rec = json.loads(f.readline())
    assert {"kind", "frames", "wall_s", "fps", "width", "height", "device",
            "stages", "coverage_fallback_chunks", "chunks"} <= set(rec)
    assert (rec["kind"], rec["frames"], rec["width"], rec["height"],
            rec["device"], rec["chunks"], rec["coverage_fallback_chunks"]) \
        == ("stabilize", 6, 64, 48, "cpu", 2, 0)
    assert {"decode", "compute", "encode"} <= set(rec["stages"])
    params, mcfg = ckpt.load_npz(FAST)
    np.testing.assert_array_equal(_read_dir(tmp_path / "out"),
                                  _stab(params, mcfg).stabilize_clip(frames))


@pytest.mark.parametrize("extra,match", [
    (["--warp-impl", "lax"], "one warp route"),
    (["--warp-impl", "pallas"], "one warp route"),
    (["--chunk-frames", "-1"], "--chunk-frames must be >= 1"),
])
@pytest.mark.parametrize("command", ["stabilize", "stabilize-batch"])
def test_refused_flags_exit_2(tmp_path, capsys, command, extra, match):
    io = (["--input", str(tmp_path), "--output", str(tmp_path / "o")]
          if command == "stabilize" else
          ["--inputs", str(tmp_path), "--outputs", str(tmp_path / "o")])
    assert cli.main([command, *io, "--platform", "cpu", *extra]) == 2
    assert match in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "o")


@pytest.mark.parametrize("command", ["stabilize", "stabilize-batch"])
def test_dtype_bfloat16_runs_the_bf16_model(tmp_path, command):
    """--dtype bfloat16 re-applies onto the committed fast checkpoint's
    config (it was refused before bf16 was ported): the output is the
    library's bf16 Stabilizer's, bytewise."""
    frames = _clip(6, key=12)
    src = _write_dir(tmp_path / "in", frames)
    io = (["--input", src, "--output", str(tmp_path / "out")]
          if command == "stabilize" else
          ["--inputs", src, "--outputs", str(tmp_path / "out")])
    assert cli.main([command, *io, "--platform", "cpu", "--chunk-frames",
                     "4", "--dtype", "bfloat16"]) == 0
    params, mcfg = ckpt.load_npz(FAST)
    want = _stab(params, dataclasses.replace(mcfg, dtype="bfloat16")
                 ).stabilize_clip(frames)
    np.testing.assert_array_equal(_read_dir(tmp_path / "out"), want)


def test_usage_names_every_command(capsys):
    assert cli.main([]) == 1
    out = capsys.readouterr().out
    assert "stabilize-batch" in out and "eval" in out


@pytest.mark.parametrize("argv", [[], ["-h"], ["--help"], ["bench"]],
                         ids=["none", "-h", "--help", "unknown"])
def test_main_exits_as_the_reference(argv, capsys):
    """0 for help, 1 for no arguments (usage on stdout), 2 for an unknown
    command with the reference's message."""
    from dvsg_tpu import cli as jcli
    rc = cli.main(argv)
    port = capsys.readouterr()
    assert rc == jcli.main(argv)
    ref = capsys.readouterr()
    assert bool(port.out) == bool(ref.out) and bool(port.err) == bool(ref.err)
    assert port.err == ref.err


@pytest.mark.parametrize("argv", [
    ["stabilize", "--input", "/nonexistent.mp4", "--output", "o.mp4"],
    ["stabilize-batch", "--inputs", "/nonexistent.mp4", "--outputs",
     "o.mp4"],
    ["train", "--checkpoint", "{tmp}/ck", "--steps", "1", "--batch-size",
     "1", "--data", "/nonexistent.mp4", *TINY],
    ["stabilize", "--input", "{tmp}", "--output", "{tmp}/o.mp4"],
], ids=["stabilize", "stabilize-batch", "train", "empty-dir"])
def test_user_errors_exit_as_the_reference(argv, tmp_path, capsys):
    """A missing input prints the reference's one line (``ERROR: not found:
    <path>``) and exits 2, with no traceback."""
    from dvsg_tpu import cli as jcli
    argv = [a.format(tmp=tmp_path) for a in argv] + ["--platform", "cpu"]
    rc = cli.main(argv)
    port = capsys.readouterr().err.strip().splitlines()[-1]
    assert rc == jcli.main(argv) == 2
    ref = capsys.readouterr().err.strip().splitlines()[-1]
    assert port == ref and port.startswith("ERROR: not found: ")


# --- stabilize-batch ---------------------------------------------------------

def test_stabilize_batch_matches_library(tmp_path):
    clips = [_clip(5, key=4), _clip(7, key=5)]
    ins = [_write_dir(tmp_path / f"in{i}", c) for i, c in enumerate(clips)]
    outs = [str(tmp_path / f"out{i}") for i in range(2)]
    metrics = str(tmp_path / "m.jsonl")
    assert cli.main(["stabilize-batch", "--inputs", *ins, "--outputs", *outs,
                     "--chunk-frames", "4", "--platform", "cpu", "--no-mesh",
                     "--path-smooth", "8", "--metrics-out", metrics]) == 0
    params, mcfg = ckpt.load_npz(FAST)
    for clip, out in zip(clips, outs):
        np.testing.assert_array_equal(
            _read_dir(out), _stab(params, mcfg, path_smooth=8)
            .stabilize_clip(clip))
    with open(metrics) as f:
        rec = json.loads(f.readline())
    assert (rec["kind"], rec["clips"], rec["frames"], rec["failed_clips"],
            rec["coverage_fallback_chunks"]) \
        == ("stabilize_batch", 2, 12, [], [0, 0])


def test_stabilize_batch_shares_an_auto_crop(tmp_path, capsys):
    clips = [_clip(6, key=6), _clip(4, key=7)]
    ins = [_write_dir(tmp_path / f"in{i}", c) for i, c in enumerate(clips)]
    outs = [str(tmp_path / f"out{i}") for i in range(2)]
    assert cli.main(["stabilize-batch", "--inputs", *ins, "--outputs", *outs,
                     "--chunk-frames", "4", "--platform", "cpu",
                     "--border-crop", "auto"]) == 0
    err = capsys.readouterr().err
    assert "auto border-crop (shared over 2 clips): max |offset|" in err
    params, mcfg = ckpt.load_npz(FAST)
    cfg = StabilizeConfig(model=mcfg, chunk_frames=4)
    crop, _ = autocrop.crop_for_max_offset(max(
        autocrop.scan_clip_max_offset(cfg, params, c, device="cpu")
        for c in clips))
    assert f"-> crop {crop:.4f}" in err
    for clip, out in zip(clips, outs):
        np.testing.assert_array_equal(
            _read_dir(out), _stab(params, mcfg, border_crop=crop)
            .stabilize_clip(clip))


def test_stabilize_batch_refuses_mixed_resolutions_before_writing(tmp_path):
    ins = [_write_dir(tmp_path / "a", _clip(4, key=8)),
           _write_dir(tmp_path / "b", _clip(4, key=9, h=32, w=64))]
    outs = [str(tmp_path / "oa.avi"), str(tmp_path / "ob")]
    assert cli.main(["stabilize-batch", "--inputs", *ins, "--outputs", *outs,
                     "--platform", "cpu"]) == 2
    assert not any(os.path.exists(o) for o in outs)
    assert cli.main(["stabilize-batch", "--inputs", *ins, "--outputs",
                     outs[0], "--platform", "cpu"]) == 2
    assert cli.main(["stabilize-batch", "--inputs", ins[0], "--outputs",
                     outs[0], "--platform", "cpu", "--path-smooth", "8",
                     "--path-smooth-lag", "4"]) == 2
    assert not any(os.path.exists(o) for o in outs)


def test_stabilize_batch_exits_3_on_a_failed_clip(tmp_path, monkeypatch,
                                                  capsys):
    clips = [_clip(8, key=10), _clip(8, key=11)]
    ins = [_write_dir(tmp_path / f"in{i}", c) for i, c in enumerate(clips)]
    outs = [str(tmp_path / f"out{i}") for i in range(2)]
    real = video_io.VideoReader

    class Failing(real):
        def read_batch(self, n, out=None):
            if self.path == ins[1] and self._pos >= 4:
                raise IOError("injected mid-stream decode failure")
            return super().read_batch(n, out)

    monkeypatch.setattr(video_io, "VideoReader", Failing)
    assert cli.main(["stabilize-batch", "--inputs", *ins, "--outputs", *outs,
                     "--chunk-frames", "4", "--platform", "cpu"]) == 3
    assert f"FAILED clip {ins[1]} after 4 frames" in capsys.readouterr().err
    params, mcfg = ckpt.load_npz(FAST)
    np.testing.assert_array_equal(_read_dir(outs[0]),
                                  _stab(params, mcfg).stabilize_clip(
                                      clips[0]))
    assert _read_dir(outs[1]).shape[0] == 4


def test_stabilize_batch_closes_writers_on_device_failure(tmp_path,
                                                          monkeypatch):
    ins = [_write_dir(tmp_path / f"in{i}", _clip(4, key=12 + i))
           for i in range(2)]
    closed = []
    real = video_io.VideoWriter

    class Spy(real):
        def close(self):
            closed.append(self)
            super().close()

    def boom(*a, **k):
        raise RuntimeError("injected device failure")

    monkeypatch.setattr(video_io, "VideoWriter", Spy)
    monkeypatch.setattr("dvsg_tpu_torch.pipeline.multiclip.stabilize_multi",
                        boom)
    with pytest.raises(RuntimeError, match="injected device failure"):
        cli.main(["stabilize-batch", "--inputs", *ins, "--outputs",
                  str(tmp_path / "o0"), str(tmp_path / "o1"),
                  "--platform", "cpu"])
    assert len(closed) == 2


# --- the reference's argv (C6) -----------------------------------------------

SMALL = os.path.join(ROOT, "checkpoints", "small.npz")
_EVAL = ["--clips", "1", "--frames", "4", "--size", "64", "64"]
_EXPORT = ["--size", "64", "64", "--output", "{tmp}/m"]
_IO = {"stabilize": ["--input", "{in}", "--output", "{tmp}/o"],
       "stabilize-batch": ["--inputs", "{in}", "--outputs", "{tmp}/o"],
       "eval": _EVAL, "export": _EXPORT}
_T4 = ["--chunk-frames", "4"]
_CK = ["--checkpoint", SMALL]

# Where the two CLIs part, and why: the port's exit code and last stderr
# line stand for themselves there.
_PORT_OWN_LINE = "the port refuses with its own line"
ARGV_CASES = {
    **{f"{c}-checkpoint-and-preset": [c, *io, *_CK, "--preset", "quality",
                                      *_T4] for c, io in _IO.items()},
    **{f"{c}-warp-impl-{w}": [c, *_IO[c], *_CK, *_T4, "--warp-impl", w]
       for c in ("eval", "export") for w in ("auto", "pallas", "lax")},
    **{f"{c}-chunk-frames-{t}": [c, *io, *_CK, "--chunk-frames", t]
       for c, io in _IO.items() for t in ("0", "-1")},
    **{f"{c}-missing-checkpoint": [c, *io, "--checkpoint", "{tmp}/no.npz",
                                   *_T4] for c, io in _IO.items()},
    "stabilize-missing-checkpoint-dir": ["stabilize", *_IO["stabilize"],
                                         "--checkpoint", "{tmp}/nodir"],
    "stabilize-missing-artifact": ["stabilize", *_IO["stabilize"],
                                   "--artifact", "{tmp}/no.dvsgt"],
}
# rc (port, reference) where they differ, else one rc.
ARGV_DIFFERS = {
    # The reference runs its lax warp; the port has one warp route (C2).
    "eval-warp-impl-lax": (2, 0), "export-warp-impl-lax": (2, 0),
}
# Cases whose last stderr lines differ, both exiting 2.
LINE_DIFFERS = {
    # The reference fails in its Pallas call ("Only interpret mode is
    # supported on CPU backend"); the port names its one warp route.
    "eval-warp-impl-pallas", "export-warp-impl-pallas",
    # A negative T: the reference fails wherever the run first trips on it
    # (numpy's "negative dimensions are not allowed", "need at least one
    # array to concatenate", a zero-size export); the port refuses it
    # before any work with "--chunk-frames must be >= 1".
    *(f"{c}-chunk-frames--1" for c in _IO),
}


@pytest.fixture(scope="module")
def argv_input(tmp_path_factory):
    """A seeded 4-frame 64x64 frame directory."""
    d = tmp_path_factory.mktemp("argv")
    return _write_dir(d / "in", _clip(4, key=21, h=64, w=64))


def _run(main, argv, tmp, inp, capsys):
    """(exit code, last stderr line, stdout) of ``main`` on ``argv`` with
    its paths under ``tmp``, on the CPU."""
    os.makedirs(tmp, exist_ok=True)
    argv = [a.format(tmp=tmp, **{"in": inp}) for a in argv]
    rc = main(argv + ["--platform", "cpu"])
    out = capsys.readouterr()
    lines = out.err.strip().splitlines()
    return rc, (lines[-1] if lines else ""), out.out


@pytest.mark.parametrize("case", sorted(ARGV_CASES))
def test_reference_argv_exits_as_the_reference(case, argv_input, tmp_path,
                                               capsys):
    """Each argv through both CLIs on the CPU (small.npz, 64x64): the
    exit code and the last stderr line are the reference's, except where
    ``ARGV_DIFFERS``/``LINE_DIFFERS`` record why they part.

    * ``--checkpoint`` with ``--preset``: the checkpoint wins (the quality
      preset's weights would not fit small.npz's frames equally).
    * ``--chunk-frames 0``: the auto pick, T = 16, with the reference's
      notice as the last line ("auto-picked T=16 for 64x64 (cpu sweep)").
    * a missing ``--checkpoint`` (an .npz, a directory) or ``--artifact``:
      ``ERROR: not found: [Errno 2] No such file or directory: '<path>'``
      (for a directory the reference names its ``model_config.json``).
    """
    from dvsg_tpu import cli as jcli
    argv = ARGV_CASES[case]
    rc, line, out = _run(cli.main, argv, str(tmp_path / "port"),
                         argv_input, capsys)
    jrc, jline, _ = _run(jcli.main, argv, str(tmp_path / "ref"), argv_input,
                         capsys)
    want_rc = ARGV_DIFFERS.get(case, (jrc, jrc))
    assert (rc, jrc) == want_rc, (line, jline)
    if case in LINE_DIFFERS:
        assert rc == jrc == 2 and line.startswith("ERROR: ")
    elif case not in ARGV_DIFFERS:
        assert line == jline.replace(str(tmp_path / "ref"),
                                     str(tmp_path / "port"))
    if "missing" in case:
        assert line.startswith("ERROR: not found: [Errno 2] No such file")
    if case == "stabilize-checkpoint-and-preset":
        # The checkpoint's weights ran, not the preset's.
        params, mcfg = ckpt.load_npz(SMALL)
        np.testing.assert_array_equal(
            _read_dir(tmp_path / "port" / "o"),
            _stab(params, mcfg).stabilize_clip(_read_dir(argv_input)))
    if case == "stabilize-chunk-frames-0":
        params, mcfg = ckpt.load_npz(SMALL)
        want = Stabilizer(StabilizeConfig(model=mcfg, chunk_frames=16),
                          params, device="cpu")
        np.testing.assert_array_equal(
            _read_dir(tmp_path / "port" / "o"),
            want.stabilize_clip(_read_dir(argv_input)))
    if case == "eval-warp-impl-auto":
        assert "psnr_gain_db" in out


def _parser(main, argv=()):
    """The ArgumentParser ``main`` builds, caught at its parse."""
    import argparse
    from unittest import mock

    class Caught(Exception):
        pass

    def catch(self, *a, **k):
        raise Caught(self)
    with mock.patch.object(argparse.ArgumentParser, "parse_args", catch):
        with pytest.raises(Caught) as got:
            main(list(argv))
    return got.value.args[0]


def _options(parser) -> set:
    return {o for a in parser._actions for o in a.option_strings}


def test_every_reference_option_is_accepted():
    """Every option string of the reference's parsers (each subcommand and
    the server) is one the port's parser takes, so a flag the reference
    adds cannot drift unseen. The port's own extras (the smoothing set on
    export and stabilize-batch, --for-platform choices) are not held."""
    from dvsg_tpu import cli as jcli
    from dvsg_tpu import serve as jserve
    from dvsg_tpu_torch import serve
    pairs = {name: (getattr(cli, f"{fn}_main"), getattr(jcli, f"{fn}_main"))
             for name, fn in (("stabilize", "stabilize"),
                              ("stabilize-batch", "stabilize_batch"),
                              ("train", "train"), ("eval", "eval"),
                              ("export", "export"))}
    pairs["serve"] = (serve.main, jserve.main)
    for name, (port, ref) in pairs.items():
        missing = _options(_parser(ref)) - _options(_parser(port))
        assert not missing, f"{name}: the port refuses {sorted(missing)}"
    assert "--warp-impl" in _options(_parser(cli.eval_main))


def test_server_takes_the_checkpoint_over_the_preset(monkeypatch, capsys):
    """``serve --checkpoint small.npz --preset quality`` serves the
    checkpoint, as the reference's server does (its ``_resolve_preset``).
    A missing checkpoint: the reference's server raises
    ``FileNotFoundError`` (exit 1, a traceback); the port's keeps its one
    line, ``ERROR: checkpoint <path> does not exist``, and exit 2."""
    from dvsg_tpu_torch import serve
    seen = {}

    class Server:
        server_address = ("127.0.0.1", 0)

        def serve_forever(self):
            raise KeyboardInterrupt

        def server_close(self):
            pass

    def make_server(host, port, engine, desc, **kw):
        seen.update(desc=desc, cfg=engine.cfg)
        return Server()
    monkeypatch.setattr(serve, "make_server", make_server)
    assert serve.main(["--checkpoint", SMALL, "--preset", "quality",
                       "--platform", "cpu"]) == 0
    assert seen["desc"] == f"checkpoint:{SMALL}"
    assert seen["cfg"].model == ckpt.load_npz(SMALL)[1]
    assert serve.main(["--checkpoint", "/nonexistent.npz",
                       "--platform", "cpu"]) == 2
    assert capsys.readouterr().err.strip().splitlines()[-1] == (
        "ERROR: checkpoint /nonexistent.npz does not exist")
