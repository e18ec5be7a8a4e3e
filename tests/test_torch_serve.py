"""The port's HTTP server (dvsg_tpu_torch/serve.py) on the CPU, over
localhost with a stdlib client (a mirror of tests/test_serve.py): every
response's container equals encoding the single-clip ``Stabilizer``'s
output of the decoded upload, byte for byte."""

import concurrent.futures
import http.client
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from dvsg_tpu_torch import serve
from dvsg_tpu_torch.config import ModelConfig, StabilizeConfig
from dvsg_tpu_torch.models import motion_cnn
from dvsg_tpu_torch.pipeline.batching import BatchStabilizer
from dvsg_tpu_torch.pipeline.stabilize import Stabilizer
from dvsg_tpu_torch.train import synthetic
from dvsg_tpu_torch.utils import video_io
from dvsg_tpu_torch.utils.checkpoint import load_npz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MCFG = ModelConfig(window=3, model_size=(32, 32), grid_size=(8, 8),
                   base_features=8, blocks_per_level=1)
CFG = StabilizeConfig(model=MCFG, chunk_frames=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    """The tiny model with a head that moves pixels."""
    gen = torch.Generator().manual_seed(0)
    p = motion_cnn.init_params(MCFG, gen)
    p["head_out.weight"] = 0.05 * torch.randn(p["head_out.weight"].shape,
                                              generator=gen)
    return p


def _start(engine, **kw):
    srv = serve.make_server("127.0.0.1", 0, engine, "test-model", **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def server(params):
    engine = BatchStabilizer(CFG, params, max_batch=4, window_s=0.0,
                             device="cpu")
    srv, url = _start(engine)
    yield srv, url
    srv.shutdown()
    engine.close()


def _clip(n, key=3, h=32, w=48):
    return synthetic.synthetic_clip_u8(torch.Generator().manual_seed(key),
                                       n, h, w)[0].numpy()


def _encode(tmp_path, name, frames):
    path = str(tmp_path / name)
    with video_io.VideoWriter(path, frames.shape[2], frames.shape[1],
                              fps=24.0) as w:
        w.write_batch(frames)
    with open(path, "rb") as f:
        return f.read()


def _decode(tmp_path, data, name="dec.mp4"):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    with video_io.VideoReader(path) as r:
        return r.read_batch(1000)


def _post(url, data, query=""):
    req = urllib.request.Request(url + "/stabilize" + query, data=data,
                                 method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, dict(r.headers), r.read()


def _expected(tmp_path, cfg, params, payload, name="want.mp4"):
    """The container of the single-clip output of the decoded upload."""
    frames = _decode(tmp_path, payload, "up_" + name)
    out = Stabilizer(cfg, params, device="cpu").stabilize_clip(frames)
    return _encode(tmp_path, name, out), len(frames)


def test_healthz_names_the_device(server):
    _, url = server
    with urllib.request.urlopen(url + "/healthz") as r:
        assert r.status == 200
        body = r.read().decode()
    assert '"status": "ok"' in body and "test-model" in body
    assert '"device": "cpu"' in body and "batching" in body


@pytest.mark.parametrize("fmt", ["mp4", "webm"])
def test_stabilize_roundtrip(server, params, tmp_path, fmt):
    _, url = server
    payload = _encode(tmp_path, "in.mp4", _clip(9))
    status, headers, body = _post(url, payload, f"?format={fmt}")
    assert status == 200 and headers["X-Frames"] == "9"
    assert headers["Content-Type"] == f"video/{fmt}"
    want, n = _expected(tmp_path, CFG, params, payload, f"want.{fmt}")
    # A webm container carries a random segment id: compare its pictures.
    assert n == 9
    np.testing.assert_array_equal(_decode(tmp_path, body, f"got.{fmt}"),
                                  _decode(tmp_path, want, f"ref.{fmt}"))


def test_bad_requests(server):
    _, url = server
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(url + "/nope")
    assert e.value.code == 404
    for data, query, match in ((b"", "", "empty body"),
                               (b"garbage", "", "no decodable frames"),
                               (b"garbage", "?format=../../evil",
                                "unsupported format")):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url, data, query)
        assert e.value.code == 400
        assert match in e.value.read().decode()
    srv, _ = server
    conn = http.client.HTTPConnection(*srv.server_address, timeout=10)
    try:
        conn.putrequest("POST", "/stabilize")
        conn.putheader("Content-Length", "abc")
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == 400 and b"Content-Length" in resp.read()
    finally:
        conn.close()


def test_server_fault_is_500_and_oversize_is_413(params, tmp_path):
    """An engine failure answers 5xx with no internals in the body; an
    oversized upload answers 413."""
    engine = BatchStabilizer(CFG, params, max_batch=2, window_s=0.0,
                             device="cpu")

    def boom(frames, border_crop=None):
        raise RuntimeError("device lost /tmp/secret/path")

    engine.stabilize_clip = boom
    srv, url = _start(engine, max_upload_bytes=10_000)
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url, _encode(tmp_path, "in.mp4", _clip(4)))
        assert e.value.code == 500
        body = e.value.read().decode()
        assert "/tmp" not in body and "secret" not in body
        assert "RuntimeError" in body
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url, b"x" * 20_000)
        assert e.value.code == 413
    finally:
        srv.shutdown()
        engine.close()


def test_concurrent_requests_share_one_device_batch(params, tmp_path):
    engine = BatchStabilizer(CFG, params, max_batch=3, window_s=5.0,
                             device="cpu")
    srv, url = _start(engine)
    try:
        payloads = [_encode(tmp_path, f"c{i}.mp4", _clip(6, key=10 + i))
                    for i in range(3)]
        with concurrent.futures.ThreadPoolExecutor(3) as ex:
            results = list(ex.map(lambda p: _post(url, p), payloads))
        assert [r[1]["X-Frames"] for r in results] == ["6"] * 3
        assert engine.stats["max_group"] == 3, engine.stats
        for i, (p, r) in enumerate(zip(payloads, results)):
            assert r[2] == _expected(tmp_path, CFG, params, p,
                                     f"w{i}.mp4")[0]
    finally:
        srv.shutdown()
        engine.close()


@pytest.mark.parametrize("kw", [{}, dict(path_smooth=8)],
                         ids=["prefix-replay", "causal-carry"])
def test_long_upload_segments_equal_whole(params, tmp_path, kw):
    """Bounded-memory segments of ~8 raw frames give the same container as
    one whole-upload pass: the plain mode replays a window-1 prefix, the
    smoothed mode threads the engine's carry."""
    cfg = CFG.replace(**kw)
    engine = BatchStabilizer(cfg, params, max_batch=2, window_s=0.0,
                             device="cpu")
    state = serve._State()
    state.engine = engine
    data = _encode(tmp_path, "long.mp4", _clip(26, key=20, h=40))
    try:
        small, n_small, _ = serve._stabilize_bytes(
            state, data, "mp4", segment_bytes=8 * 40 * 48 * 3)
        whole, n_whole, _ = serve._stabilize_bytes(state, data, "mp4")
    finally:
        engine.close()
    assert n_small == n_whole == 26
    assert small == whole
    assert whole == _expected(tmp_path, cfg, params, data)[0]


def test_lag_serving_whole_upload(params, tmp_path):
    """Lag mode serves one-segment uploads byte-identically to the offline
    lag run and answers longer ones with a client error."""
    cfg = CFG.replace(path_smooth=8, path_smooth_lag=4)
    engine = BatchStabilizer(cfg, params, max_batch=2, window_s=0.0,
                             device="cpu")
    state = serve._State()
    state.engine = engine
    data = _encode(tmp_path, "in.mp4", _clip(14, key=21, h=40))
    try:
        out_bytes, n, _ = serve._stabilize_bytes(state, data, "mp4")
        assert n == 14
        assert out_bytes == _expected(tmp_path, cfg, params, data)[0]
        with pytest.raises(ValueError, match="path-smooth-lag"):
            serve._stabilize_bytes(state, data, "mp4",
                                   segment_bytes=8 * 40 * 48 * 3)
    finally:
        engine.close()


def test_per_request_autocrop(tmp_path):
    """--border-crop auto: two concurrent uploads with different shake get
    their own measured crops (X-Border-Crop), each response equal to the
    single-clip run at that crop; /healthz lists the crops seen."""
    params, mcfg = load_npz(os.path.join(ROOT, "checkpoints",
                                         "flagship_fast.npz"))
    cfg = StabilizeConfig(model=mcfg, chunk_frames=4)
    engine = BatchStabilizer(cfg, params, max_batch=2, window_s=5.0,
                             device="cpu")
    srv, url = _start(engine, autocrop=True)
    gen = torch.Generator().manual_seed(21)
    still = synthetic.random_still(torch.Generator().manual_seed(22), 96,
                                   128)
    payloads = []
    for name, trans, angle in (("calm", 0.01, 0.003), ("wild", 0.2, 0.05)):
        path = synthetic.random_camera_path(gen, 8, max_trans=trans,
                                            max_angle=angle, max_persp=0.0)
        frames = synthetic.to_u8(synthetic.jitter_frames(still, path))
        payloads.append(_encode(tmp_path, f"{name}.mp4", frames.numpy()))
    try:
        with concurrent.futures.ThreadPoolExecutor(2) as ex:
            res = list(ex.map(lambda p: _post(url, p), payloads))
        crops = [float(r[1]["X-Border-Crop"]) for r in res]
        assert crops[1] > crops[0]
        for i, (p, r, crop) in enumerate(zip(payloads, res, crops)):
            assert r[1]["X-Frames"] == "8"
            want, _ = _expected(tmp_path, cfg.replace(
                border_crop=round(crop * 64) / 64), params, p, f"a{i}.mp4")
            assert r[2] == want
        with urllib.request.urlopen(url + "/healthz") as r:
            assert "crops_seen" in r.read().decode()
    finally:
        srv.shutdown()
        engine.close()


@pytest.mark.parametrize("args,match", [
    (["--border-crop", "0.7"], "border-crop"),
    (["--warp-impl", "lax"], "one warp route"),
    (["--warp-impl", "pallas"], "one warp route"),
    (["--checkpoint", "nope.npz"], "does not exist"),
])
def test_main_refuses(args, match, capsys):
    assert serve.main([*args, "--platform", "cpu"]) == 2
    assert match in capsys.readouterr().err
