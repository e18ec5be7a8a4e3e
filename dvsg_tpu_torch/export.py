"""Ahead-of-time export of the stabilization chunk step (``torch.export``).

The whole per-chunk device program (matrix-form resize → CNN forward →
the offsets kernel) is traced into a ``torch.export.ExportedProgram`` with
the weights inside, so a serving host runs it with this module and the
registered op alone: no checkpoint, no model code. The offsets kernel is
recorded as the op ``dvsg_torch::warp_u8_offsets_rows`` (ops/warp_wide.py):
on the card the artifact launches the CUDA kernel, on the CPU its plain
version.

Artifact layout (single file; the port's own format, which the JAX
package's ``.dvsgx`` files are not)::

    b"DVSGT1\\n" | u32 header_len | header JSON (utf-8) | torch.export.save bytes

The header records the config (the model's ``dtype`` and ``arch``
among it, which ``load_exported`` rebuilds), the input and output shapes
and types, the device type the program was traced on, the clip ranks it was cut for
(``nr_devices``) and the torch version, and is checked at load time. The
calling convention is the JAX package's:

    (frames_u8 (T, H, W, C), halo (window-1, mh, mw, C) f32)
      -> (stabilized_u8 (T, H, W, C), new_halo, offsets (T, gh, gw, 2))

and with ``cfg.path_smooth > 0`` a (4,) f32 smoothing state in and out:

    (frames_u8, halo, smooth_state) -> (stabilized_u8, new_halo,
                                        new_smooth_state, offsets)

A batch artifact takes the same with a leading clip axis. The fixed-lag
mode is not exported (its signature has no slot for the delayed frames).
An artifact runs on the device type it was traced for.

``for_device="cuda"`` exports for the card from any host, one without a
card included: the step is traced under fake CUDA tensors, so every branch
on the device (cuDNN's bf16 convolution, the fixed-size calls of
ops/grouped.py) takes its card side. The weights and the shape-keyed
tables are built real on the CPU and stored in the file as such; loading
on the card puts them there. The JAX package picks a warp route for the
target platform (``resolve_cfg_platforms``); the port has one route, the
registered op, so there is nothing to pick.
"""

from __future__ import annotations

import dataclasses
import io
import itertools
import json
import struct
import sys
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.overrides import TorchFunctionMode

from dvsg_tpu_torch import resolve_device
from dvsg_tpu_torch.config import (StabilizeConfig, config_to_json,
                                   stabilize_config_from_dict)
from dvsg_tpu_torch.ops import warp_wide  # noqa: F401 — registers the op
from dvsg_tpu_torch.parallel import mesh as mesh_lib
from dvsg_tpu_torch.pipeline import pathsmooth
from dvsg_tpu_torch.pipeline.stabilize import (ChunkStep, Stabilizer,
                                               build_model,
                                               drive_chunked_batch,
                                               initial_halo)

_MAGIC = b"DVSGT1\n"
_REFERENCE_MAGIC = b"DVSGX1\n"      # dvsg_tpu.export's artifacts
_FORMAT = "dvsgt"
_FORMAT_VERSION = 1


@dataclasses.dataclass
class Exported:
    """An exported chunk program and what its header records."""

    program: torch.export.ExportedProgram
    device: torch.device            # the device it was traced on
    nr_devices: int                 # clip ranks of a batch artifact
    in_avals: list                  # [[shape], dtype] of each input
    out_avals: list
    export_s: float                 # seconds the trace took


class _ChunkProgram(torch.nn.Module):
    """The pure chunk step of ``cfg``'s mode closed over (cfg, model), with
    or without a leading clip axis (``ChunkStep.program``)."""

    def __init__(self, cfg: StabilizeConfig, model: torch.nn.Module):
        super().__init__()
        self.model = model
        self.step = ChunkStep(cfg, model).program

    def forward(self, frames_u8, halo, *smooth_state):
        return self.step(frames_u8, halo, *smooth_state)


def _avals(tensors) -> list:
    return [[list(t.shape), str(t.dtype).removeprefix("torch.")]
            for t in tensors]


def _export(cfg: StabilizeConfig, params: dict, lead: tuple, height: int,
            width: int, device: torch.device, nr_devices: int) -> Exported:
    """Trace the chunk step for inputs with leading axes ``lead`` ((B,) for
    a batch, () for one clip)."""
    model = build_model(cfg.model, params, device)
    prog = _ChunkProgram(cfg, model)
    frames = torch.zeros(lead + (cfg.chunk_frames, height, width,
                                 cfg.model.channels),
                         dtype=torch.uint8, device=device)
    halo = initial_halo(cfg, np.zeros((height, width, cfg.model.channels),
                                      np.uint8), device)
    args = (frames, halo.expand(lead + halo.shape).contiguous())
    if cfg.path_smooth > 0:
        args += (torch.zeros(lead + (pathsmooth.STATE_DIM,),
                             dtype=torch.float32, device=device),)
    # One eager call first: the shape-keyed tables (resize matrices,
    # smoothing tables) are then cached as real tensors, which the trace
    # records as constants. Built during the trace they would be fake.
    with torch.no_grad():
        outs = prog(*args)
    t0 = time.perf_counter()
    program = torch.export.export(prog, args)
    # The saved program would carry the example chunk (44 MB at 720p).
    program.example_inputs = None
    return Exported(program, device, nr_devices, _avals(args), _avals(outs),
                    time.perf_counter() - t0)


# The device a trace for the card runs on. An index is needed: without one,
# placing a tensor asks the CUDA runtime which card is current.
_CARD = torch.device("cuda", 0)
_aten = torch.ops.aten
_CASTS = {"float": torch.float32, "bfloat16": torch.bfloat16,
          "long": torch.int64, "int": torch.int32, "double": torch.float64,
          "half": torch.float16, "bool": torch.bool, "byte": torch.uint8}


def _getitem(x: torch.Tensor, index) -> torch.Tensor:
    """``x[index]`` as the aten ops PyTorch's indexing applies: integers
    select, slices slice, None unsqueezes, and tensors index afterwards
    with the sliced dimensions left in place."""
    index = index if isinstance(index, tuple) else (index,)
    used = sum(i is not None and i is not Ellipsis for i in index)
    out, dim, advanced = x, 0, []
    for i in index:
        if i is Ellipsis:
            k = x.dim() - used
            advanced += [None] * k
            dim += k
        elif i is None:
            out = out.unsqueeze(dim)
            advanced.append(None)
            dim += 1
        elif isinstance(i, int) and not isinstance(i, bool):
            out = out.select(dim, i)
        elif isinstance(i, slice):
            out = _aten.slice.Tensor(out, dim, i.start, i.stop,
                                     1 if i.step is None else i.step)
            advanced.append(None)
            dim += 1
        elif isinstance(i, torch.Tensor) and i.dtype != torch.bool:
            advanced.append(i)
            dim += 1
        else:
            raise TypeError(f"index {i!r} is not traced for the card")
    while advanced and advanced[-1] is None:
        advanced.pop()
    return _aten.index.Tensor(out, advanced) if advanced else out


class _CardMethods(TorchFunctionMode):
    """Tensor methods whose Python bindings take a CUDA device guard, which
    a build of torch without CUDA cannot give, not even to a fake tensor:
    on fake CUDA tensors they run as the aten ops they stand for
    (indexing, ``to`` and the casts as ``_to_copy``, ``contiguous`` as a
    clone). The trace records the same ops either way."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        x = args[0] if args else None
        if not (isinstance(x, FakeTensor) and x.is_cuda):
            return func(*args, **kwargs)
        name = getattr(func, "__name__", "")
        if func is torch.Tensor.__getitem__:
            return _getitem(x, args[1])
        if func is torch.Tensor.to:
            dev, dtype, _, fmt = torch._C._nn._parse_to(*args[1:], **kwargs)
            if (dev in (None, x.device) and dtype in (None, x.dtype)
                    and fmt is None):
                return x
            return _aten._to_copy.default(
                x, dtype=dtype or x.dtype, device=dev or x.device,
                memory_format=fmt)
        if name == "contiguous" and not args[1:] and not kwargs:
            return x if x.is_contiguous() else _aten.clone.default(
                x, memory_format=torch.contiguous_format)
        if name in _CASTS and not args[1:] and not kwargs:
            dtype = _CASTS[name]
            return x if x.dtype == dtype else _aten._to_copy.default(
                x, dtype=dtype)
        return func(*args, **kwargs)


def _export_for_card(cfg: StabilizeConfig, params: dict, lead: tuple,
                     height: int, width: int, nr_devices: int) -> Exported:
    """Trace the chunk step for the card under fake CUDA tensors (no card
    needed). The program's weights are the real CPU parameters, and the
    tables it builds from numpy are real CPU constants that the graph
    copies to the card."""
    if cfg.model.arch == "pwc" and not torch.backends.cuda.is_built():
        # F.grid_sample's fake-CUDA decomposition needs a CUDA build.
        raise ValueError("arch 'pwc' is exported for the card on a host "
                         "whose PyTorch is built with CUDA; this one is "
                         "not (its feature warp does not trace here)")
    prog = _ChunkProgram(cfg, build_model(cfg.model, params,
                                          torch.device("cpu")))
    real = dict(prog.named_parameters())
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        for mod in prog.modules():
            for name, p in list(mod._parameters.items()):
                mod._parameters[name] = torch.nn.Parameter(
                    mode.from_tensor(p.detach()).to(_CARD),
                    requires_grad=False)
        c = cfg.model.channels
        mh, mw = cfg.model.model_size
        args = (torch.empty(lead + (cfg.chunk_frames, height, width, c),
                            dtype=torch.uint8, device=_CARD),
                torch.empty(lead + (cfg.model.window - 1, mh, mw, c),
                            device=_CARD))
        if cfg.path_smooth > 0:
            args += (torch.empty(lead + (pathsmooth.STATE_DIM,),
                                 device=_CARD),)
    t0 = time.perf_counter()
    with _CardMethods():
        program = torch.export.export(prog, args)
    export_s = time.perf_counter() - t0
    if set(program.state_dict) != set(real):
        raise RuntimeError("the traced program's weights are not the "
                           "model's: " + str(sorted(set(program.state_dict)
                                                    ^ set(real))))
    for name, t in real.items():
        program.state_dict[name] = torch.nn.Parameter(t.detach(),
                                                      requires_grad=False)
    fake = [k for k, v in program.constants.items()
            if isinstance(v, FakeTensor)]
    if fake:
        raise RuntimeError(f"constants {fake} of the trace for the card "
                           "have no values")
    program.example_inputs = None
    outs = next(n for n in program.graph.nodes if n.op == "output").args[0]
    return Exported(program, _CARD, nr_devices, _avals(args),
                    _avals([n.meta["val"] for n in outs]), export_s)


def _export_any(cfg: StabilizeConfig, params: dict, lead: tuple,
                height: int, width: int, device, for_device,
                nr_devices: int) -> Exported:
    if for_device is None:
        return _export(cfg, params, lead, height, width, device, nr_devices)
    target = torch.device(for_device)
    if target.type == "cuda":
        return _export_for_card(cfg, params, lead, height, width,
                                nr_devices)
    if target.type != "cpu":
        raise ValueError(f"for_device must be cuda or cpu, got "
                         f"{for_device!r}")
    return _export(cfg, params, lead, height, width, target, nr_devices)


def export_chunk_program(cfg: StabilizeConfig, params: dict, height: int,
                         width: int, device="cuda",
                         for_device: Optional[str] = None) -> Exported:
    """Export the single-clip chunk step with ``params`` inside, for
    (cfg.chunk_frames, height, width, C) uint8 chunks on ``device``; or,
    with ``for_device``, for that device type from this host whatever it
    has (``"cuda"``: traced under fake CUDA tensors, no card needed)."""
    pathsmooth.lag_reject(
        cfg, "AOT export (the artifact signature has no shifted-emission "
             "slot; export the causal smoother instead)")
    dev = None if for_device is not None else resolve_device(device)
    return _export_any(cfg, params, (), height, width, dev, for_device, 1)


def export_batch_program(cfg: StabilizeConfig, params: dict, n_clips: int,
                         height: int, width: int,
                         mesh: Optional[mesh_lib.Mesh] = None,
                         device="cuda",
                         for_device: Optional[str] = None) -> Exported:
    """Export the batched chunk step for ``n_clips`` clips: with a mesh,
    the step of one rank's n_clips/n clips (every rank of the mesh loads
    the same artifact for its shard; the header records n); without one,
    all clips on ``device``. ``for_device`` as in
    ``export_chunk_program``."""
    pathsmooth.lag_reject(cfg, "AOT batch export")
    n = 1 if mesh is None else mesh.size
    if n_clips % n:
        raise ValueError(f"n_clips {n_clips} must divide over {n} devices")
    dev = None
    if for_device is None:
        dev = resolve_device(device) if mesh is None else mesh.device
    return _export_any(cfg, params, (n_clips // n,), height, width, dev,
                       for_device, n)


def save_exported(exp: Exported, path: str, cfg: StabilizeConfig,
                  extra: Optional[Dict[str, Any]] = None) -> None:
    """Write the artifact file (magic | header | serialized program)."""
    header = {
        "format": _FORMAT,
        "version": _FORMAT_VERSION,
        "torch_version": torch.__version__,
        "device": str(exp.device),
        "config": json.loads(config_to_json(cfg)),
        "in_avals": exp.in_avals,
        "out_avals": exp.out_avals,
        "nr_devices": exp.nr_devices,
    }
    if extra:
        header.update(extra)
    hdr = json.dumps(header, sort_keys=True).encode("utf-8")
    buf = io.BytesIO()
    torch.export.save(exp.program, buf)
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(hdr)))
        f.write(hdr)
        f.write(buf.getvalue())


class _ArtifactStabilizer(Stabilizer):
    """A ``Stabilizer`` whose device step is an artifact's program: every
    streaming loop (sync with resume, overlapped, online) runs on it
    unchanged."""

    def __init__(self, loaded: "ExportedStabilizer"):
        # Stabilizer's state without a model: the program holds the weights.
        self.cfg = loaded.cfg
        self.device = loaded.device
        self.model = None
        self.chunks_seen = 0
        self.coverage_fallbacks = 0
        self.step = ChunkStep(self.cfg, program=loaded._module,
                              device=self.device)


class ExportedStabilizer:
    """A loaded artifact: the Stabilizer API without model code.

    ``chunk`` is the raw exported step; ``engine`` is a ``Stabilizer`` on
    it, for whole clips (``stabilize_clip``) and every streaming loop;
    ``stabilize_clips`` drives a batch artifact.
    """

    def __init__(self, program: torch.export.ExportedProgram,
                 meta: Dict[str, Any], device: torch.device,
                 mesh: Optional[mesh_lib.Mesh] = None):
        self.meta = meta
        self.device = device
        self.mesh = mesh
        self._module = program.module()
        self.cfg = stabilize_config_from_dict(meta["config"])
        self.smooth = self.cfg.path_smooth > 0
        shape, _ = meta["in_avals"][0]
        self.batched = len(shape) == 5
        if self.batched:
            (self.n_clips, self.chunk_frames, self.height, self.width,
             self.channels) = shape
            self.n_clips *= int(meta.get("nr_devices", 1))
        else:
            self.n_clips = None
            self.chunk_frames, self.height, self.width, self.channels = \
                shape

    def chunk(self, frames_u8: torch.Tensor, halo: torch.Tensor,
              smooth_state: Optional[torch.Tensor] = None):
        """The raw exported step, on this artifact's device. A smoothed
        artifact (``self.smooth``) takes and returns the extra state:
        (out, new_halo, new_state, offsets) against (out, new_halo,
        offsets)."""
        if not self.smooth:
            return self._module(frames_u8, halo)
        if smooth_state is None:
            raise ValueError(
                "this artifact was exported with path_smooth="
                f"{self.cfg.path_smooth}: chunk() needs the carried "
                "smooth_state (pathsmooth.initial_state() at stream start)")
        return self._module(frames_u8, halo, smooth_state)

    def engine(self) -> Stabilizer:
        """A ``Stabilizer`` whose device step is the artifact's program.
        Single-clip artifacts only; the input resolution must be the
        exported one."""
        if self.batched:
            raise ValueError("batched artifact: engine() needs a "
                             "single-clip export")
        return _ArtifactStabilizer(self)

    def stabilize_clips(self, clips_u8: np.ndarray) -> np.ndarray:
        """Batch artifacts: (B, T_total, H, W, C) uint8 → stabilized, B the
        exported clip count; over a mesh each rank runs its shard and every
        rank gets the whole batch back (``dp.ShardedClipStabilizer``'s
        loop)."""
        if not self.batched:
            raise ValueError("single-clip artifact: use stabilize_clip")
        if clips_u8.shape[0] != self.n_clips:
            raise ValueError(f"artifact was exported for {self.n_clips} "
                             f"clips, got {clips_u8.shape[0]}")
        mine = clips_u8
        if self.mesh is not None:
            mine = clips_u8[self.mesh.shard(self.n_clips, "clip batch")]
        out = drive_chunked_batch(
            ChunkStep(self.cfg, program=self._module, device=self.device,
                      batched=True), mine)
        if self.mesh is not None:
            out = mesh_lib.all_gather_rows(self.mesh, out)
        return out

    def stabilize_clip(self, frames_u8: np.ndarray) -> np.ndarray:
        """frames_u8 (T, H, W, C) uint8 → stabilized (T, H, W, C): the
        engine's clip loop (chunks, halo and state carry, tail padding)."""
        if self.batched:
            raise ValueError(f"batched artifact ({self.n_clips} clips): use "
                             "stabilize_clips")
        if len(frames_u8) and frames_u8.shape[1:] != (
                self.height, self.width, self.channels):
            raise ValueError(
                f"artifact was exported for frames "
                f"{(self.height, self.width, self.channels)}, got "
                f"{tuple(frames_u8.shape[1:])}")
        return self.engine().stabilize_clip(frames_u8)


def read_header(path: str):
    """(header dict, program bytes) of an artifact file, checked: the
    magic, the header's length and format version, and that program bytes
    follow."""
    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic == _REFERENCE_MAGIC:
            raise ValueError(
                f"{path} is an artifact of the JAX package (dvsg_tpu.export, "
                f"magic {_REFERENCE_MAGIC!r}); the PyTorch port reads only "
                f"its own artifacts (magic {_MAGIC!r}): export one with "
                "python -m dvsg_tpu_torch export")
        if magic != _MAGIC:
            raise ValueError(f"{path} is not a {_FORMAT} artifact (bad magic "
                             f"{magic!r})")
        raw_len = f.read(4)
        if len(raw_len) < 4:
            raise ValueError(f"{path}: truncated artifact (no header "
                             "length)")
        (hdr_len,) = struct.unpack("<I", raw_len)
        raw_hdr = f.read(hdr_len)
        if len(raw_hdr) < hdr_len:
            raise ValueError(f"{path}: truncated artifact (header cut short "
                             f"at {len(raw_hdr)}/{hdr_len} bytes)")
        meta = json.loads(raw_hdr.decode("utf-8"))
        blob = f.read()
    if meta.get("format") != _FORMAT or (
            meta.get("version") != _FORMAT_VERSION):
        raise ValueError(
            f"{path}: unsupported artifact format {meta.get('format')!r} "
            f"v{meta.get('version')!r} (this loader reads {_FORMAT} "
            f"v{_FORMAT_VERSION}); re-export with this version of the port")
    if not blob:
        raise ValueError(f"{path}: truncated artifact (no program bytes "
                         "after the header)")
    return meta, blob


def load_exported(path: str, device=None,
                  mesh: Optional[mesh_lib.Mesh] = None
                  ) -> ExportedStabilizer:
    """Read an artifact file, check its header, load the program.

    It runs on ``device`` (default: the mesh's device, else the device it
    was exported for), which must be of the type it was exported for; a
    batch artifact cut for n ranks needs a mesh of n. Its weights and
    tables are put on that device. Raises ``ValueError`` on a file that is
    not the port's artifact, a truncated file or an unsupported format
    version, and ``RuntimeError`` for a card's device on a host without
    one; warns (stderr) when the artifact was made under another torch
    version.
    """
    meta, blob = read_header(path)
    made_on = torch.device(meta["device"])
    if device is None:
        device = mesh.device if mesh is not None else made_on
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{path} was exported for the card (cuda) and "
                           "runs only there; this host has no CUDA device")
    dev = resolve_device(device)
    if dev.type != made_on.type:
        raise ValueError(f"{path} was exported for {made_on.type}, not "
                         f"{dev.type}; export it again on a {dev.type} "
                         "device")
    need = int(meta.get("nr_devices", 1))
    have = 1 if mesh is None else mesh.size
    if need != have:
        raise ValueError(f"{path} was exported for {need} devices (a mesh "
                         f"of {need}); this process has a mesh of {have}")
    if meta.get("torch_version") != torch.__version__:
        print(f"WARNING: {path} was exported under torch "
              f"{meta.get('torch_version')}, this process runs "
              f"{torch.__version__}; export it again if loading or running "
              "it fails", file=sys.stderr)
    program = torch.export.load(io.BytesIO(blob))
    tensors = itertools.chain(program.state_dict.values(),
                              program.constants.values())
    if dev != made_on or any(isinstance(t, torch.Tensor) and t.device != dev
                             for t in tensors):
        from torch.export.passes import move_to_device_pass
        program = move_to_device_pass(program, str(dev))
    return ExportedStabilizer(program, meta, dev, mesh)
