"""Minimal serving endpoint for stabilization jobs (PyTorch port).

A threaded stdlib HTTP server (no extra dependencies; decoding and encoding
the uploads needs OpenCV, as utils/video_io.py does) exposing:

  GET  /healthz            → {"status": "ok", "device": ..., "model": ...}
  POST /stabilize          → body: a video container (e.g. mp4); response:
                             the stabilized container. Query params:
                             ?format=mp4 (default)

Device work goes through ``pipeline.batching.BatchStabilizer``: one device
worker groups concurrent requests (a few-ms window) into one batched chunk
step and hands each request its clip back, so N concurrent requests share
the card instead of queueing for it. Decode and encode stay on the request
thread. Run (on the card; ``--platform cpu`` for the CPU):

  python -m dvsg_tpu_torch.serve --preset fast --port 8799
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

# Container formats VideoWriter can encode; anything else is refused with a
# clear 400 (the raw query value would otherwise reach temp file names and
# the Content-Type header).
_ALLOWED_FORMATS = frozenset({"mp4", "m4v", "mov", "avi", "mkv", "webm"})


class _State:
    engine = None               # BatchStabilizer (owns the device worker)
    model_desc = ""
    max_upload = 1 << 30        # request-body cap in bytes (see do_POST)
    autocrop = False            # --border-crop auto: measure per request


def _build_handler(state: _State):

    class Handler(BaseHTTPRequestHandler):
        server_version = "dvsg-tpu-torch"

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/healthz"):
                self._json(200, {"status": "ok",
                                 "device": str(state.engine.device),
                                 "model": state.model_desc,
                                 "autocrop": state.autocrop,
                                 "batching": dict(state.engine.stats)})
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if not self.path.startswith("/stabilize"):
                self._json(404, {"error": "unknown path"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
            except ValueError:
                self._json(400, {"error": "bad Content-Length header"})
                return
            if length <= 0:
                self._json(400, {"error": "empty body"})
                return
            if length > state.max_upload:
                self._json(413, {
                    "error": f"body is {length} bytes; the server caps "
                             f"uploads at {state.max_upload} (each "
                             "request thread buffers its body in RAM)"})
                return
            data = self.rfile.read(length)
            from urllib.parse import parse_qs, urlsplit
            q = parse_qs(urlsplit(self.path).query)
            fmt = q.get("format", ["mp4"])[0]
            if fmt not in _ALLOWED_FORMATS:
                self._json(400, {
                    "error": f"unsupported format {fmt!r}; allowed: "
                             + ", ".join(sorted(_ALLOWED_FORMATS))})
                return
            try:
                out_bytes, n, crop = _stabilize_bytes(state, data, fmt)
            except ValueError as e:
                # Client-input problems, with messages that name no server
                # path.
                self._json(400, {"error": str(e)})
                return
            except Exception as e:  # noqa: BLE001
                # Anything else is a server fault (device, writer, codec):
                # 5xx for monitoring, internals kept out of the body.
                self._json(500, {"error": "internal stabilization "
                                          f"failure ({type(e).__name__})"})
                return
            self.send_response(200)
            self.send_header("Content-Type", f"video/{fmt}")
            self.send_header("X-Frames", str(n))
            if crop is not None:
                self.send_header("X-Border-Crop", f"{crop:.6f}")
            self.send_header("Content-Length", str(len(out_bytes)))
            self.end_headers()
            self.wfile.write(out_bytes)

    return Handler


def _read_sanitized(reader, n: int):
    """A decode error mid-stream is the client's broken container; the
    decoder's own message can carry the server's temp path, so re-raise a
    clean ValueError (→ 400)."""
    try:
        return reader.read_batch(n)
    except Exception:
        raise ValueError("request body stopped decoding mid-stream")


def _stabilize_bytes(state: _State, data: bytes, fmt: str,
                     segment_bytes: int = 256 * 1024 * 1024):
    """Decode → stabilize → encode with bounded memory.

    Long uploads are processed in raw-frame segments of ~``segment_bytes``
    and stay exact, in one of three ways:

    * plain: each segment is prefixed with the previous segment's last
      window-1 raw frames, whose outputs are dropped, so every kept frame's
      window is its true history (the carried halo is pure input history);
    * path smoothing (causal): the engine's carry API threads the halo and
      the smoothing state across chunk-aligned segments;
    * fixed lag: whole uploads only, capped at one segment (the lag carries
      hold D raw frames, which the carry API does not ship).

    ``--border-crop auto`` (state.autocrop): the request's crop is measured
    by the predict-only scan (pipeline/autocrop.py) on the first segment
    and kept for the rest. Returns (bytes, frames, crop or None).
    """
    import numpy as np

    from dvsg_tpu_torch.utils import video_io

    engine = state.engine
    window = engine.cfg.model.window
    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, f"in.{fmt}")
        dst = os.path.join(d, f"out.{fmt}")
        with open(src, "wb") as f:
            f.write(data)
        try:
            reader_cm = video_io.VideoReader(src)
        except Exception:
            raise ValueError("no decodable frames in request body")
        with reader_cm as reader:
            fps = reader.fps
            w, h = reader.width, reader.height
            frame_bytes = max(1, h * w * 3)
            seg = max(engine.cfg.chunk_frames,
                      int(segment_bytes // frame_bytes))
            # Decode before the writer exists: an undecodable body must
            # answer "no decodable frames", not a writer error.
            c = _read_sanitized(reader, seg)
            if c.shape[0] == 0:
                raise ValueError("no decodable frames in request body")
            req_crop = None
            if state.autocrop:
                from dvsg_tpu_torch.pipeline.autocrop import pick_border_crop
                req_crop, _, _ = pick_border_crop(
                    engine.cfg, engine.params, c, device=engine.device)
            n_out = 0
            with video_io.VideoWriter(dst, w, h, fps) as writer:
                if engine.cfg.path_smooth_lag > 0:
                    if _read_sanitized(reader, 1).shape[0]:
                        raise ValueError(
                            "upload too long for --path-smooth-lag serving "
                            f"(decodes past the ~{seg}-frame segment cap); "
                            "shorten the clip or use a causal --path-smooth "
                            "server for segmented streaming")
                    out = engine.stabilize_clip(c, border_crop=req_crop)
                    writer.write_batch(out)
                    n_out = out.shape[0]
                elif engine.cfg.path_smooth > 0:
                    chunk = engine.cfg.chunk_frames
                    seg_al = max(chunk, seg // chunk * chunk)
                    buf, eof = c, c.shape[0] < seg
                    carry = None
                    while True:
                        if buf.shape[0] < seg_al and not eof:
                            # Top up to one segment only, so at most about
                            # one segment of raw frames is buffered.
                            need = seg_al - buf.shape[0]
                            nxt = _read_sanitized(reader, need)
                            eof = nxt.shape[0] < need
                            if nxt.shape[0]:
                                buf = np.concatenate([buf, nxt], axis=0)
                            continue
                        if buf.shape[0] == 0:
                            break     # the stream ended on a boundary
                        final = eof and buf.shape[0] <= seg_al
                        piece = buf if final else buf[:seg_al]
                        buf = buf[:0] if final else buf[seg_al:].copy()
                        if final:
                            out = engine.stabilize_clip(
                                piece, border_crop=req_crop, carry=carry)
                        else:
                            out, carry = engine.stabilize_clip(
                                piece, border_crop=req_crop, carry=carry,
                                return_carry=True)
                        writer.write_batch(out)
                        n_out += out.shape[0]
                        del out, piece
                        if final:
                            break
                else:
                    prefix = None            # last window-1 raw frames
                    while c.shape[0] > 0:
                        inp = c if prefix is None else np.concatenate(
                            [prefix, c], axis=0)
                        out = engine.stabilize_clip(inp,
                                                    border_crop=req_crop)
                        drop = 0 if prefix is None else prefix.shape[0]
                        writer.write_batch(out[drop:])
                        n_out += out.shape[0] - drop
                        if c.shape[0] < seg:
                            break
                        # A copy: a slice would keep the whole previous
                        # segment alive.
                        prefix = (inp[-(window - 1):].copy()
                                  if window > 1 else None)
                        del inp, out
                        c = _read_sanitized(reader, seg)
        with open(dst, "rb") as f:
            return f.read(), n_out, req_crop


def make_server(host: str, port: int, engine, model_desc: str = "",
                max_upload_bytes: int = 1 << 30,
                autocrop: bool = False) -> ThreadingHTTPServer:
    """``engine``: a pipeline.batching.BatchStabilizer."""
    state = _State()
    state.engine = engine
    state.model_desc = model_desc
    state.max_upload = max_upload_bytes
    state.autocrop = autocrop
    srv = ThreadingHTTPServer((host, port), _build_handler(state))
    srv.engine = engine
    return srv


def main(argv=None) -> int:
    from dvsg_tpu_torch import cli

    p = argparse.ArgumentParser(prog="python -m dvsg_tpu_torch.serve")
    p.add_argument("--checkpoint", default=None,
                   help="training checkpoint directory or .npz")
    p.add_argument("--preset", choices=tuple(cli._PRESETS),
                   help="committed pretrained model (default: fast)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8799)
    p.add_argument("--chunk-frames", type=int, default=16)
    cli._add_warp_impl_arg(p)
    p.add_argument("--platform", choices=("cuda", "cpu"), default="cuda",
                   help="device to run on (default cuda)")
    p.add_argument("--max-batch", type=int, default=8,
                   help="max concurrent requests fused into one device step")
    p.add_argument("--batch-window-ms", type=float, default=5.0,
                   help="how long the device worker waits for "
                        "co-travellers after a request arrives")
    p.add_argument("--strength", type=float, default=1.0,
                   help="stabilization strength (1 full, 0 passthrough)")
    p.add_argument("--path-smooth", type=int, default=0, metavar="FRAMES",
                   help="camera-path smoothing horizon (see stabilize "
                        "--path-smooth); long uploads thread the smoothing "
                        "state across segments exactly")
    p.add_argument("--path-smooth-max", type=float, default=0.05,
                   help="clamp on the smoothing correction")
    p.add_argument("--path-smooth-lag", type=int, default=0, metavar="D",
                   help="fixed-lag smoothing lookahead (see stabilize "
                        "--path-smooth-lag); uploads must fit one raw-frame "
                        "segment (longer ones answer 400)")
    p.add_argument("--border-crop", default="0",
                   help="crop fraction zoomed into the warp, or 'auto': "
                        "each request's crop is measured by a predict-only "
                        "scan of its first segment and returned in the "
                        "X-Border-Crop header; requests group by "
                        "(resolution, crop)")
    p.add_argument("--max-upload-mb", type=int, default=1024,
                   help="refuse request bodies above this size with 413")
    args = p.parse_args(argv)

    if cli._bad_warp_impl(args.warp_impl):
        return 2
    border_crop = cli._parse_border_crop(args.border_crop)
    if border_crop is None:
        return 2
    path = cli._checkpoint_path(args)       # --checkpoint wins
    if not os.path.exists(path):
        return cli._err(f"checkpoint {path} does not exist")
    params, mcfg = cli._load_any_checkpoint(path)
    autocrop = border_crop == "auto"
    try:
        from dvsg_tpu_torch.config import StabilizeConfig
        cfg = StabilizeConfig(model=mcfg, chunk_frames=args.chunk_frames,
                              border_crop=0.0 if autocrop else border_crop,
                              strength=args.strength,
                              path_smooth=args.path_smooth,
                              path_smooth_max=args.path_smooth_max,
                              path_smooth_lag=args.path_smooth_lag)
    except ValueError as e:
        return cli._err(str(e))
    from dvsg_tpu_torch.pipeline.batching import BatchStabilizer
    engine = BatchStabilizer(cfg, params, max_batch=args.max_batch,
                             window_s=args.batch_window_ms / 1e3,
                             device=args.platform)
    desc = f"checkpoint:{path}"
    srv = make_server(args.host, args.port, engine, desc,
                      max_upload_bytes=args.max_upload_mb << 20,
                      autocrop=autocrop)
    print(f"serving on http://{args.host}:{srv.server_address[1]} "
          f"({desc}, {engine.device})", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
        engine.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
