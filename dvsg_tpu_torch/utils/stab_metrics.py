"""Literature-standard video-stabilization metrics on RAW frames.

The synthetic-jitter harness (train/eval.py) measures fidelity against a
constructible ground truth; these metrics need NO ground truth — they
estimate inter-frame camera motion by feature tracking (cv2 LK optical
flow + robust similarity/affine fits), so they apply to REAL footage.
The trio follows the video
stabilization literature (StabNet / DIFRINT / DUT evaluation protocol):

  * stability score — energy of the low-frequency components of the
    estimated camera path (translation and rotation sequences), as a
    fraction of total non-DC energy. Smooth paths concentrate energy in
    low frequencies; 1.0 is perfectly smooth, higher is better.
  * cropping ratio — scale of the similarity fit between input and
    output frame t (a stabilizer zooms in to hide borders; ratio is
    1/scale, closer to 1.0 keeps more field of view).
  * distortion value — anisotropy of the affine fit between input and
    output (min/max singular value of the 2x2 linear part); 1.0 means
    no shear/non-uniform scaling, higher is better.

All functions take (T, H, W, C) uint8 RGB numpy arrays and run on the
host (cv2). They are measurement utilities, not part of the device path.
A copy of the reference package's module (numpy and cv2 only).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover - cv2 is baked into the image
    cv2 = None

_MAX_CORNERS = 300
_MIN_TRACKS = 12


def _gray(frame: np.ndarray) -> np.ndarray:
    if frame.shape[-1] == 1:
        return frame[..., 0]
    if frame.shape[-1] == 4:
        frame = frame[..., :3]
    return cv2.cvtColor(frame, cv2.COLOR_RGB2GRAY)


def _track(prev_gray: np.ndarray, gray: np.ndarray):
    """LK-tracked corner pairs between two frames, or (None, None)."""
    p0 = cv2.goodFeaturesToTrack(prev_gray, maxCorners=_MAX_CORNERS,
                                 qualityLevel=0.01, minDistance=8,
                                 blockSize=7)
    if p0 is None or len(p0) < _MIN_TRACKS:
        return None, None
    p1, st, _ = cv2.calcOpticalFlowPyrLK(prev_gray, gray, p0, None)
    if p1 is None:
        return None, None
    good = st.ravel() == 1
    if good.sum() < _MIN_TRACKS:
        return None, None
    return p0[good], p1[good]


def _similarity(p0, p1) -> Optional[np.ndarray]:
    a, _ = cv2.estimateAffinePartial2D(p0, p1, method=cv2.RANSAC,
                                       ransacReprojThreshold=2.0)
    return a


def _gray_seq(frames: np.ndarray):
    return [_gray(f) for f in frames]


def camera_path(frames: np.ndarray,
                grays: Optional[list] = None) -> np.ndarray:
    """Per-step estimated camera motion:
    (T-1, 4) [dx_px, dy_px, dtheta, dlog_scale].

    Similarity fit between consecutive frames; steps whose tracking
    fails carry NaN (zero would read as "no motion" — the maximally
    OPTIMISTIC value for a stability metric, not a conservative one).
    The log-scale column reads the similarity fit's zoom component
    (the quantity pathsmooth's scale smoothing corrects).
    """
    if cv2 is None:  # pragma: no cover
        raise RuntimeError("cv2 unavailable")
    t = frames.shape[0]
    grays = grays or _gray_seq(frames)
    out = np.full((max(t - 1, 0), 4), np.nan, np.float64)
    for i in range(1, t):
        p0, p1 = _track(grays[i - 1], grays[i])
        if p0 is not None:
            a = _similarity(p0, p1)
            if a is not None:
                s = float(np.hypot(a[0, 0], a[1, 0]))
                out[i - 1] = (a[0, 2], a[1, 2],
                              float(np.arctan2(a[1, 0], a[0, 0])),
                              np.log(max(s, 1e-9)))
    return out


def _lowfreq_score(x: np.ndarray, k: int = 5) -> float:
    """Energy share of FFT components 1..k among all non-DC components
    of the ACCUMULATED path (the literature's stability protocol)."""
    path = np.cumsum(x)
    spec = np.abs(np.fft.fft(path)) ** 2
    half = spec[1:len(spec) // 2 + 1]
    total = float(half.sum())
    if total <= 0:
        return 1.0
    return float(half[:k].sum()) / total


_MIN_PATH = 12          # k=5 low-freq bins need > 5 non-DC components
_MAX_FAIL_FRAC = 0.2    # more failed steps than this -> untrackable


def stability_score(frames: np.ndarray,
                    grays: Optional[list] = None) -> Dict[str, float]:
    """Low-frequency energy share of the estimated camera path.

    Returns per-component scores and their mean. NaN when the clip is
    too short for the spectrum to be meaningful (< _MIN_PATH steps —
    shorter paths have <= k non-DC bins and score a trivial 1.0) or
    when more than _MAX_FAIL_FRAC of the steps failed to track
    (featureless footage must read as "unmeasurable", not "perfect").
    """
    nan = {"stability": float("nan"), "stability_t": float("nan"),
           "stability_r": float("nan")}
    path = camera_path(frames, grays=grays)
    if path.shape[0] < _MIN_PATH:
        return nan
    failed = np.isnan(path[:, 0])
    if failed.mean() > _MAX_FAIL_FRAC:
        return nan
    path = np.where(np.isnan(path), 0.0, path)  # few gaps: neutral fill
    sx = _lowfreq_score(path[:, 0])
    sy = _lowfreq_score(path[:, 1])
    sr = _lowfreq_score(path[:, 2])
    st = 0.5 * (sx + sy)
    return {"stability": (st + sr) / 2.0, "stability_t": st,
            "stability_r": sr}


def _in_out_affine(gray_in: np.ndarray, gray_out: np.ndarray):
    p0, p1 = _track(gray_in, gray_out)
    if p0 is None:
        return None
    a, _ = cv2.estimateAffine2D(p0, p1, method=cv2.RANSAC,
                                ransacReprojThreshold=2.0)
    return a


def cropping_and_distortion(frames_in: np.ndarray,
                            frames_out: np.ndarray,
                            grays_in: Optional[list] = None,
                            grays_out: Optional[list] = None
                            ) -> Dict[str, float]:
    """Cropping ratio and distortion value from per-frame input→output
    affine fits (mean over frames with successful tracking)."""
    if cv2 is None:  # pragma: no cover
        raise RuntimeError("cv2 unavailable")
    grays_in = grays_in or _gray_seq(frames_in)
    grays_out = grays_out or _gray_seq(frames_out)
    crops, dists = [], []
    for fi, fo in zip(grays_in, grays_out):
        a = _in_out_affine(fi, fo)
        if a is None:
            continue
        lin = a[:, :2]
        sv = np.linalg.svd(lin, compute_uv=False)
        if sv[0] <= 0:
            continue
        scale = float(np.sqrt(abs(np.linalg.det(lin))))
        if scale > 0:
            crops.append(min(1.0, 1.0 / scale))
        dists.append(float(sv[-1] / sv[0]))
    return {
        "cropping_ratio": float(np.mean(crops)) if crops else float("nan"),
        "distortion_value": (float(np.mean(dists)) if dists
                             else float("nan")),
        "tracked_frames": float(len(dists)),
    }


def stability_report(frames_in: np.ndarray,
                     frames_out: np.ndarray) -> Dict[str, float]:
    """Full no-ground-truth report: stability score of input and output
    paths, cropping ratio, and distortion value. Grayscale conversions
    are shared between the path and in→out fits (cv2 is the expensive
    part of this report)."""
    rep = {}
    grays_in = _gray_seq(frames_in)
    grays_out = _gray_seq(frames_out)
    s_in = stability_score(frames_in, grays=grays_in)
    s_out = stability_score(frames_out, grays=grays_out)
    rep["stability_in"] = s_in["stability"]
    rep["stability_out"] = s_out["stability"]
    rep.update(cropping_and_distortion(frames_in, frames_out,
                                       grays_in, grays_out))
    return rep
