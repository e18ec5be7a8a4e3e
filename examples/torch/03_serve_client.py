#!/usr/bin/env python
"""HTTP serving round trip with the PyTorch port: start the server, POST a
clip, save the stabilized result.

The server (``python -m dvsg_tpu_torch.serve``) batches requests that
arrive within a few milliseconds of each other into one device step per
resolution. This script starts one on a free localhost port, writes a
synthetic shaky clip to mp4, POSTs it, saves the response and stops the
server.

    python examples/torch/03_serve_client.py [--device cpu]
"""
import argparse
import os
import socket
import subprocess
import sys
import tempfile
import time
import urllib.request

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--out", default=os.path.join(
        tempfile.gettempdir(), "dvsg_torch_example_stable.mp4"))
    args = ap.parse_args()

    import cv2
    import torch

    from dvsg_tpu_torch import resolve_device
    from dvsg_tpu_torch.train.synthetic import synthetic_clip_u8

    resolve_device(args.device)             # no card and no --device cpu
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    work = tempfile.TemporaryDirectory()
    server = subprocess.Popen(
        [sys.executable, "-m", "dvsg_tpu_torch.serve", "--preset", "fast",
         "--port", str(port), "--platform", args.device], cwd=ROOT)
    try:
        url = f"http://127.0.0.1:{port}"
        for _ in range(600):                      # wait for /healthz
            if server.poll() is not None:
                raise SystemExit(f"server exited with {server.returncode}")
            try:
                urllib.request.urlopen(f"{url}/healthz", timeout=1)
                break
            except OSError:
                time.sleep(0.5)

        # A small shaky clip to send.
        shaky, _, _ = synthetic_clip_u8(torch.Generator().manual_seed(0),
                                        args.frames, 240, 320)
        clip = os.path.join(work.name, "shaky.mp4")
        vw = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*"mp4v"), 24,
                             (320, 240))
        for f in shaky.numpy():
            vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        vw.release()

        with open(clip, "rb") as f:
            req = urllib.request.Request(f"{url}/stabilize", data=f.read(),
                                         method="POST")
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as resp:
            body = resp.read()
        with open(args.out, "wb") as f:
            f.write(body)
        print(f"stabilized {len(body)} bytes -> {args.out} "
              f"in {time.perf_counter() - t0:.1f}s")
    finally:
        server.terminate()
        server.wait(timeout=30)
        work.cleanup()


if __name__ == "__main__":
    main()
