"""The port's export (export.py) on the CPU: the artifact reproduces the
live pipeline byte for byte (plain, causal, batched, the streaming engine),
its header and file checks, the CLI's ``export`` and ``stabilize
--artifact``, and the refusal of the JAX package's ``.dvsgx`` files
(mirrors of tests/test_export.py)."""

import io
import json
import os
import struct

import numpy as np
import pytest
import torch

from dvsg_tpu import export as jexport
from dvsg_tpu.config import ModelConfig as JModelConfig
from dvsg_tpu.config import StabilizeConfig as JStabilizeConfig
from dvsg_tpu.utils import checkpoint as jckpt
from dvsg_tpu_torch import cli
from dvsg_tpu_torch import export as export_lib
from dvsg_tpu_torch.config import StabilizeConfig
from dvsg_tpu_torch.ops import resize as resize_ops
from dvsg_tpu_torch.parallel import dryrun
from dvsg_tpu_torch.pipeline import pathsmooth
from dvsg_tpu_torch.pipeline import stabilize as st
from dvsg_tpu_torch.train import synthetic
from dvsg_tpu_torch.utils import checkpoint as ckpt
from dvsg_tpu_torch.utils import video_io

MCFG, PARAMS = dryrun.tiny_setup()
CFG = StabilizeConfig(model=MCFG, chunk_frames=4)
H, W = 48, 64
MODES = {"plain": {}, "causal": dict(path_smooth=8)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clip(n, key):
    return synthetic.synthetic_clip_u8(torch.Generator().manual_seed(key),
                                       n, H, W)[0].numpy()


@pytest.fixture(scope="module")
def frames():
    return _clip(10, key=2)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """A single-clip artifact of each mode, and a batch artifact of each
    mode for three clips."""
    d = tmp_path_factory.mktemp("art")
    out = {}
    for mode, kw in MODES.items():
        cfg = CFG.replace(**kw)
        path = str(d / f"{mode}.dvsgt")
        export_lib.save_exported(
            export_lib.export_chunk_program(cfg, PARAMS, H, W, device="cpu"),
            path, cfg, extra={"checkpoint": "unit-test"})
        out[mode] = path
        path = str(d / f"{mode}_batch.dvsgt")
        export_lib.save_exported(
            export_lib.export_batch_program(cfg, PARAMS, 3, H, W,
                                            device="cpu"), path, cfg)
        out[f"{mode}_batch"] = path
    return out


def _live(cfg, clip):
    return st.Stabilizer(cfg, PARAMS, device="cpu").stabilize_clip(clip)


@pytest.mark.parametrize("mode", list(MODES))
def test_artifact_matches_live_pipeline(artifacts, frames, mode):
    loaded = export_lib.load_exported(artifacts[mode])
    assert loaded.chunk_frames == 4 and (loaded.height, loaded.width) == (H, W)
    assert loaded.smooth == (mode == "causal")
    out = loaded.stabilize_clip(frames)
    assert out.dtype == np.uint8
    np.testing.assert_array_equal(out, _live(CFG.replace(**MODES[mode]),
                                             frames))


def test_artifact_records_the_offsets_op(artifacts):
    meta, blob = export_lib.read_header(artifacts["plain"])
    prog = torch.export.load(io.BytesIO(blob))
    targets = [str(n.target) for n in prog.graph.nodes
               if n.op == "call_function"]
    assert targets.count("dvsg_torch.warp_u8_offsets_rows.default") == 1


@pytest.mark.parametrize("mode", list(MODES))
def test_chunk_call_matches_impl(artifacts, frames, mode):
    cfg = CFG.replace(**MODES[mode])
    loaded = export_lib.load_exported(artifacts[mode])
    model = st.build_model(MCFG, PARAMS, torch.device("cpu"))
    halo = st.initial_halo(cfg, frames[0], "cpu")
    chunk = torch.from_numpy(frames[:4])
    with torch.inference_mode():
        if mode == "plain":
            got = loaded.chunk(chunk, halo)
            want = st.stabilize_chunk_impl(cfg, model, chunk, halo)
        else:
            state = pathsmooth.initial_state()
            got = loaded.chunk(chunk, halo, state)
            want = st.stabilize_chunk_smooth_impl(cfg, model, chunk, halo,
                                                  state)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if mode == "causal":
        with pytest.raises(ValueError, match="needs the carried"):
            loaded.chunk(chunk, halo)


@pytest.mark.parametrize("mode", list(MODES))
def test_batch_artifact_matches_live_batched_step(artifacts, mode):
    cfg = CFG.replace(**MODES[mode])
    clips = np.stack([_clip(7, key=k) for k in (3, 4, 5)])
    loaded = export_lib.load_exported(artifacts[f"{mode}_batch"])
    assert loaded.batched and loaded.n_clips == 3
    model = st.build_model(MCFG, PARAMS, torch.device("cpu"))
    want = st.drive_chunked_batch(st.ChunkStep(cfg, model, batched=True),
                                  clips)
    np.testing.assert_array_equal(loaded.stabilize_clips(clips), want)
    for i, c in enumerate(clips):               # and each clip alone
        np.testing.assert_array_equal(want[i], _live(cfg, c))
    with pytest.raises(ValueError, match="exported for 3 clips"):
        loaded.stabilize_clips(clips[:2])
    with pytest.raises(ValueError, match="use stabilize_clips"):
        loaded.stabilize_clip(clips[0])
    with pytest.raises(ValueError, match="single-clip export"):
        loaded.engine()


class _Reader:
    def __init__(self, frames):
        self.frames, self.pos = frames, 0

    def read_batch(self, n):
        out = self.frames[self.pos:self.pos + n]
        self.pos += len(out)
        return out

    def skip(self, n):
        self.pos += n
        return n


class _Writer:
    def __init__(self):
        self.parts = []

    def write_batch(self, f):
        self.parts.append(np.array(f))

    def seek(self, i):
        pass


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_streams_like_the_live_stabilizer(artifacts, frames, mode):
    from dvsg_tpu_torch.pipeline.overlap import stabilize_stream_overlapped
    cfg = CFG.replace(**MODES[mode])
    engine = export_lib.load_exported(artifacts[mode]).engine()
    want = _live(cfg, frames)
    for run in (engine.stabilize_stream, lambda r, w:
                stabilize_stream_overlapped(engine, r, w)):
        w = _Writer()
        assert run(_Reader(frames), w) == len(frames)
        np.testing.assert_array_equal(np.concatenate(w.parts), want)
    assert engine.chunks_seen == 2 * 3          # two runs of three chunks


def test_header_metadata(artifacts):
    loaded = export_lib.load_exported(artifacts["causal"])
    meta = loaded.meta
    assert (meta["format"], meta["version"], meta["device"],
            meta["nr_devices"], meta["checkpoint"]) == (
        "dvsgt", 1, "cpu", 1, "unit-test")
    assert meta["torch_version"] == torch.__version__
    assert meta["in_avals"] == [[[4, H, W, 3], "uint8"],
                                [[2, 32, 32, 3], "float32"],
                                [[4], "float32"]]
    assert meta["out_avals"][0] == [[4, H, W, 3], "uint8"]
    assert meta["out_avals"][-1] == [[4, 8, 8, 2], "float32"]
    assert loaded.cfg == CFG.replace(path_smooth=8)
    batch = export_lib.load_exported(artifacts["plain_batch"]).meta
    assert batch["in_avals"][0] == [[3, 4, H, W, 3], "uint8"]


def test_wrong_resolution_rejected(artifacts):
    loaded = export_lib.load_exported(artifacts["plain"])
    with pytest.raises(ValueError, match="exported for frames"):
        loaded.stabilize_clip(np.zeros((4, 32, 32, 3), np.uint8))


def _rewrite(src, dst, **header):
    meta, blob = export_lib.read_header(src)
    meta.update(header)
    hdr = json.dumps(meta).encode()
    with open(dst, "wb") as f:
        f.write(export_lib._MAGIC + struct.pack("<I", len(hdr)) + hdr + blob)
    return dst


def test_device_and_rank_count_checked(artifacts, tmp_path):
    cuda = _rewrite(artifacts["plain"], str(tmp_path / "c.dvsgt"),
                    device="cuda:0")
    with pytest.raises(ValueError, match="exported for cuda, not cpu"):
        export_lib.load_exported(cuda, device="cpu")
    two = _rewrite(artifacts["plain_batch"], str(tmp_path / "b.dvsgt"),
                   nr_devices=2)
    with pytest.raises(ValueError, match="exported for 2 devices"):
        export_lib.load_exported(two)


def test_bad_magic_rejected(tmp_path):
    path = str(tmp_path / "junk.dvsgt")
    with open(path, "wb") as f:
        f.write(b"not an artifact")
    with pytest.raises(ValueError, match="not a dvsgt artifact"):
        export_lib.load_exported(path)


def test_truncated_artifact_rejected(artifacts, tmp_path):
    blob = open(artifacts["plain"], "rb").read()
    m = len(export_lib._MAGIC)
    hdr_end = m + 4 + struct.unpack("<I", blob[m:m + 4])[0]
    for cut in (m + 2, hdr_end - 5, hdr_end):
        path = str(tmp_path / f"cut{cut}.dvsgt")
        with open(path, "wb") as f:
            f.write(blob[:cut])
        with pytest.raises(ValueError, match="truncated artifact"):
            export_lib.load_exported(path)


def test_future_format_version_rejected(tmp_path):
    hdr = json.dumps({"format": "dvsgt", "version": 99}).encode()
    path = str(tmp_path / "future.dvsgt")
    with open(path, "wb") as f:
        f.write(export_lib._MAGIC + struct.pack("<I", len(hdr)) + hdr + b"x")
    with pytest.raises(ValueError, match="unsupported artifact format"):
        export_lib.load_exported(path)


def test_reference_artifact_refused(tmp_path):
    """A .dvsgx written by the JAX package is named for what it is."""
    npz = str(tmp_path / "tiny.npz")
    ckpt.export_npz(npz, PARAMS, MCFG)
    jcfg = JStabilizeConfig(model=JModelConfig(
        window=3, model_size=(32, 32), grid_size=(8, 8), base_features=8,
        blocks_per_level=1), chunk_frames=4, warp_impl="lax")
    path = str(tmp_path / "ref.dvsgx")
    jexport.save_exported(jexport.export_chunk_program(
        jcfg, jckpt.load_npz(npz)[0], H, W), path, jcfg)
    with pytest.raises(ValueError, match="artifact of the JAX package.*"
                                         "reads only its own artifacts"):
        export_lib.load_exported(path)
    rc = cli.main(["stabilize", "--input", str(tmp_path), "--output",
                   str(tmp_path / "o"), "--artifact", path, "--platform",
                   "cpu"])
    assert rc == 2


def test_lag_not_exported():
    with pytest.raises(ValueError, match="path_smooth_lag is not supported"):
        export_lib.export_chunk_program(
            CFG.replace(path_smooth=8, path_smooth_lag=2), PARAMS, H, W,
            device="cpu")
    with pytest.raises(ValueError, match="path_smooth_lag is not supported"):
        export_lib.export_batch_program(
            CFG.replace(path_smooth=8, path_smooth_lag=2), PARAMS, 2, H, W,
            device="cpu")


def test_live_step_after_an_export_without_warm_up(frames):
    """A trace that builds the shape-keyed tables itself leaves no fake
    tensor in their caches: a live chunk afterwards returns real tensors,
    byte-equal to the step before the export."""
    cfg = CFG.replace(path_smooth=8)
    model = st.build_model(MCFG, PARAMS, torch.device("cpu"))
    halo = st.initial_halo(cfg, frames[0], "cpu")
    chunk = torch.from_numpy(frames[:4])
    state = pathsmooth.initial_state()
    with torch.inference_mode():
        want = st.stabilize_chunk_smooth_impl(cfg, model, chunk, halo, state)
    resize_ops._matrix_on.cache_clear()
    pathsmooth._on.cache_clear()
    prog = export_lib._ChunkProgram(cfg, model)
    torch.export.export(prog, (chunk, halo, state))
    with torch.inference_mode():
        got = st.stabilize_chunk_smooth_impl(cfg, model, chunk, halo, state)
    for g, w in zip(got, want):
        assert type(g) is torch.Tensor and torch.equal(g, w)


# --- export for the card from a host without one ----------------------------

@pytest.fixture(scope="module")
def card_artifacts(tmp_path_factory):
    """The single-clip step of each mode exported for the card on this
    host, which has none."""
    d = tmp_path_factory.mktemp("card")
    out = {}
    for mode, kw in MODES.items():
        cfg = CFG.replace(**kw)
        out[mode] = str(d / f"{mode}.dvsgt")
        export_lib.save_exported(export_lib.export_chunk_program(
            cfg, PARAMS, H, W, for_device="cuda"), out[mode], cfg)
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_export_for_the_card_without_one(card_artifacts, frames, mode):
    """The graph's inputs sit on cuda, its stored weights are the real
    parameters, its tables real constants; moved to the CPU, the program
    gives the live CPU step's bytes (the card's fixed-size calls give the
    same bytes there)."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.export.passes import move_to_device_pass
    cfg = CFG.replace(**MODES[mode])
    meta, blob = export_lib.read_header(card_artifacts[mode])
    assert meta["device"] == "cuda:0"
    program = torch.export.load(io.BytesIO(blob))
    inputs = [s.arg.name for s in program.graph_signature.input_specs
              if s.kind.name == "USER_INPUT"]
    nodes = {n.name: n for n in program.graph.nodes}
    assert [nodes[n].meta["val"].device.type for n in inputs] == \
        ["cuda"] * len(meta["in_avals"])
    for name, t in program.state_dict.items():
        assert not isinstance(t, FakeTensor)
        torch.testing.assert_close(t, PARAMS[name.removeprefix("model.")],
                                   rtol=0, atol=0)
    assert program.constants and not any(
        isinstance(t, FakeTensor) for t in program.constants.values())
    args = (torch.from_numpy(frames[:4]),
            st.initial_halo(cfg, frames[0], "cpu"))
    if cfg.path_smooth:
        args += (pathsmooth.initial_state(),)
    got = move_to_device_pass(program, "cpu").module()(*args)
    model = st.build_model(MCFG, PARAMS, torch.device("cpu"))
    with torch.inference_mode():
        want = export_lib._ChunkProgram(cfg, model)(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_export_for_the_card_takes_the_card_branches():
    """bf16 convolutions stay bf16 in a trace for the card (cuDNN's f32
    accumulation); the CPU's trace runs them in f32. The bf16 GELU and the
    bf16 conv bias + GroupNorm are the registered ops in the card's trace
    (their kernels on the card)."""
    import dataclasses
    cfg = CFG.replace(model=dataclasses.replace(MCFG, dtype="bfloat16"))

    def conv_dtypes(exp):
        return {n.meta["val"].dtype for n in exp.program.graph.nodes
                if n.target == torch.ops.aten.conv2d.default}
    card = export_lib.export_batch_program(cfg, PARAMS, 2, H, W,
                                           for_device="cuda")
    cpu = export_lib.export_batch_program(cfg, PARAMS, 2, H, W,
                                          device="cpu")
    assert torch.bfloat16 in conv_dtypes(card)
    assert torch.bfloat16 not in conv_dtypes(cpu)
    for op in ("gelu_bf16", "group_norm_bf16"):
        assert any(f"dvsg_torch.{op}." in str(n.target)
                   for n in card.program.graph.nodes), op
    assert card.in_avals[0] == cpu.in_avals[0] == [[2, 4, H, W, 3],
                                                   "uint8"]


def test_card_artifact_refused_without_a_card(card_artifacts):
    with pytest.raises(RuntimeError, match="exported for the card"):
        export_lib.load_exported(card_artifacts["plain"])
    with pytest.raises(ValueError, match="exported for cuda, not cpu"):
        export_lib.load_exported(card_artifacts["plain"], device="cpu")


def test_for_device_cpu_is_the_cpu_export(tmp_path):
    paths = [str(tmp_path / f"{k}.dvsgt") for k in ("device", "for_device")]
    export_lib.save_exported(export_lib.export_chunk_program(
        CFG, PARAMS, H, W, device="cpu"), paths[0], CFG)
    export_lib.save_exported(export_lib.export_chunk_program(
        CFG, PARAMS, H, W, for_device="cpu"), paths[1], CFG)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()


def test_cli_exports_for_the_card(tmp_path, capsys):
    path = str(tmp_path / "card.dvsgt")
    assert cli.main(["export", "--preset", "fast", "--size", str(H), str(W),
                     "--chunk-frames", "4", "--output", path,
                     "--for-platform", "cuda"]) == 0
    assert "program for cuda:0" in capsys.readouterr().out
    assert export_lib.read_header(path)[0]["device"] == "cuda:0"


# --- CLI ---------------------------------------------------------------------

def _write_dir(path, frames):
    with video_io.VideoWriter(str(path), frames.shape[2],
                              frames.shape[1]) as w:
        w.write_batch(frames)
    return str(path)


def _read_dir(path):
    with video_io.VideoReader(str(path)) as r:
        return r.read_batch(1000)


@pytest.fixture(scope="module")
def cli_artifact(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    npz = str(d / "tiny.npz")
    ckpt.export_npz(npz, PARAMS, MCFG)
    path = str(d / "m.dvsgt")
    assert cli.main(["export", "--checkpoint", npz, "--output", path,
                     "--size", str(H), str(W), "--chunk-frames", "4",
                     "--path-smooth", "8", "--border-crop", "0.05",
                     "--platform", "cpu"]) == 0
    return path


def test_cli_export_then_stabilize_artifact(cli_artifact, frames, tmp_path,
                                            capsys):
    src = _write_dir(tmp_path / "in", frames)
    out = str(tmp_path / "out")
    assert cli.main(["stabilize", "--input", src, "--output", out,
                     "--artifact", cli_artifact, "--platform", "cpu"]) == 0
    assert "(baked at export)" in capsys.readouterr().err
    want = _live(CFG.replace(path_smooth=8, border_crop=0.05), frames)
    np.testing.assert_array_equal(_read_dir(out), want)


@pytest.mark.parametrize("flags,match", [
    (["--preset", "fast"], "already contains the weights"),
    (["--checkpoint", "x.npz"], "already contains the weights"),
    (["--border-crop", "auto"], "needs the two-pass pipeline"),
    (["--border-crop", "0.1"], "baked at export time"),
    (["--strength", "0.5"], "baked into the artifact"),
    (["--chunk-frames", "4"], "baked into the artifact"),
    (["--warp-impl", "auto"], "baked into the artifact"),
    (["--path-smooth", "8"], "baked into the artifact"),
])
def test_artifact_flag_conflicts(cli_artifact, tmp_path, capsys, flags,
                                 match):
    rc = cli.main(["stabilize", "--input", str(tmp_path), "--output",
                   str(tmp_path / "o"), "--artifact", cli_artifact,
                   "--platform", "cpu", *flags])
    assert rc == 2
    assert match in capsys.readouterr().err


def test_artifact_resolution_mismatch_rejected(cli_artifact, tmp_path,
                                               capsys):
    small = _write_dir(tmp_path / "small", np.zeros((4, 32, 32, 3),
                                                    np.uint8))
    rc = cli.main(["stabilize", "--input", small, "--output",
                   str(tmp_path / "o"), "--artifact", cli_artifact,
                   "--platform", "cpu"])
    assert rc == 2
    assert f"exported for {W}x{H}" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "o")
