"""Cross-chunk camera-path smoothing: the long-horizon quality stage.

The motion CNN corrects each frame toward the mean camera pose of its short
causal window, so slow sway passes through it. This stage measures the
camera path and smooths it:

  1. Per-frame global camera deltas (x, y, rotation, log-scale) come from
     phase correlation between consecutive frames of the model-resolution
     sequence the chunk already computes (carried halo + this chunk):
     translation from the full frame, rotation and scale from the curl and
     divergence of four half-frame shifts.
  2. The accumulated path P is low-passed with a one-pole EMA S over a
     ``path_smooth``-frame horizon; the deviation of the CNN's target (the
     window-mean path Ā) from S is added to the predicted offsets:
     ``offsets'_t = offsets_t + (S_t − Ā_t)``.

The cross-chunk state is one f32 (x, y, θ, log-s) vector D = P − S; only
differences of P are used, so long streams lose no precision, and chunk
boundaries are exact (the output does not depend on the chunk size). The
correction is clamped to ±``path_smooth_max`` per component with
anti-windup. A fixed-lag mode (``path_smooth_lag`` = D) delays the output D
frames and smooths with a zero-phase FIR over the deltas instead.

Every function takes torch tensors on one device and keeps them there: no
step of a chunk reads a value back to the host, so chunk steps queue on the
card without waiting. The shape-only tables (Hann windows, the 1/8-px
upsampling offsets, FFT frequencies, gather indices, the lag taps) are built
once per shape and device in numpy, as the JAX package's functions compute
them, and cast once.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from dvsg_tpu_torch.config import StabilizeConfig
from dvsg_tpu_torch.ops.grouped import CHUNK_GROUP, in_groups
from dvsg_tpu_torch.ops.resize import tensor_cache

STATE_DIM = 4      # carried EMA state components: (x, y, θ, log-scale)
N_UP, SPAN = 25, 1.5          # upsampled correlation: 25 samples, ±1.5 px
_F32 = np.float32


def reject_unsupported(cfg: StabilizeConfig, surface: str) -> None:
    """Refuse a smoothing config on a surface that cannot carry the state
    (third-party code composing its own loop on the chunk steps):
    dropping the flag would ship unsmoothed output under a smoothing
    config."""
    if cfg.path_smooth > 0:
        raise ValueError(
            f"path_smooth is not supported on {surface}; the Stabilizer's "
            "clip and stream loops, the overlapped stream loop, the online "
            "push API, the clip-batch driver (drive_chunked_batch), "
            "stabilize_multi / stabilize-batch and the serving engine carry "
            "it — this caller opted out explicitly")


def lag_reject(cfg: StabilizeConfig, surface: str) -> None:
    """Refuse the fixed-lag mode where its delayed emission cannot work:
    a live consumer (online push) cannot pay a D-frame output delay, and
    the overlapped loop and the multi-clip stream driver do not do the
    emission-shift bookkeeping. Dropping the flag would ship un-lagged
    output under a lag config."""
    if cfg.path_smooth_lag > 0:
        raise ValueError(
            f"path_smooth_lag is not supported on {surface}; supported: "
            "Stabilizer.stabilize_clip / stabilize_stream (stabilize "
            "without --overlap), the in-memory clip-batch driver "
            "(drive_chunked_batch) and the serving engine's whole "
            "uploads (BatchStabilizer without segment carries)")


def initial_state(device="cpu") -> torch.Tensor:
    """Fresh smoothing state for the start of a stream: D = P − S = 0."""
    return torch.zeros((STATE_DIM,), dtype=torch.float32, device=device)


# --- shape-only tables (numpy, as the JAX package computes them) -----------

@functools.cache
def _cosf():
    """The C library's single-precision cosine: XLA's CPU backend computes
    ``jnp.cos`` with it, and numpy's own float32 cosine rounds otherwise."""
    fn = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6").cosf
    fn.argtypes, fn.restype = [ctypes.c_float], ctypes.c_float
    return fn


@functools.lru_cache(maxsize=64)
def _hann_np(n: int) -> np.ndarray:
    """0.5 − 0.5·cos(2π·i / (n − 1)) in float32 steps."""
    arg = (_F32(2.0 * math.pi) * np.arange(n, dtype=_F32)
           / _F32(max(n - 1, 1))).astype(_F32)
    cos = np.array([_cosf()(float(a)) for a in arg], _F32)
    return (_F32(0.5) - _F32(0.5) * cos).astype(_F32)


@functools.lru_cache(maxsize=64)
def _linspace_np(start: float, stop: float, n: int) -> np.ndarray:
    """``jnp.linspace(start, stop, n, dtype=float32)`` as XLA compiles it:
    step = i·f32(1/(n − 1)), start·(1 − step) + i·(stop·f32(1/(n − 1)))
    with the last product fused into the add, and the end point exact.
    (``torch.linspace`` and ``np.linspace`` round other points otherwise.)
    """
    if n == 1:
        return np.array([start], _F32)
    div = n - 1
    r = _F32(1.0 / div)
    i = np.arange(div, dtype=_F32)
    head = (_F32(start) * (_F32(1.0) - (i * r).astype(_F32))).astype(_F32)
    fused = (i.astype(np.float64) * np.float64(_F32(_F32(stop) * r))
             + head.astype(np.float64)).astype(_F32)
    return np.concatenate([fused, [_F32(stop)]]).astype(_F32)


@functools.lru_cache(maxsize=64)
def _grid_axis_np(n: int) -> np.ndarray:
    """One axis of the JAX package's (jitted) ``identity_grid``: its
    linspace from −1 to 1 with the bounds folded in, s − (1 − s) for
    s = i·f32(1/(n − 1)), and the end point exact."""
    if n == 1:
        return np.array([-1.0], _F32)
    s = (np.arange(n - 1, dtype=_F32) * _F32(1.0 / (n - 1))).astype(_F32)
    return np.concatenate([(s - (_F32(1.0) - s)).astype(_F32),
                           [_F32(1.0)]]).astype(_F32)


@functools.lru_cache(maxsize=64)
def _identity_grid_np(h: int, w: int) -> np.ndarray:
    """(h, w, 2) identity control grid, last dim (x, y) in [-1, 1]."""
    gy, gx = np.meshgrid(_grid_axis_np(h), _grid_axis_np(w), indexing="ij")
    return np.stack([gx, gy], axis=-1).astype(_F32)


@functools.lru_cache(maxsize=32)
def _lag_taps_np(horizon: int, lag: int, window: int):
    """Delta-domain FIR taps of the lag mode (numpy, cached per config).

    Returns (K, taps (K + lag,) f32): taps[m] is the coefficient of δ_{g+k}
    with k = m − K + 1; K = past horizon.
    """
    lam = 1.0 - 2.0 / (horizon + 1.0)
    k_past = max(min(2 * horizon, 96), window - 1)
    j = np.arange(-k_past, lag + 1)
    w = lam ** np.abs(j)
    w = w / w.sum()
    taps = np.zeros(k_past + lag, np.float32)
    for m in range(k_past + lag):
        k = m - k_past + 1
        if k >= 1:
            taps[m] = w[k + k_past:].sum()     # Σ_{j≥k} w_j
        else:
            taps[m] = -w[:k + k_past].sum()    # −Σ_{j≤k−1} w_j
    return k_past, taps


@tensor_cache(maxsize=256)
def _on(device: torch.device, name: str, *args) -> torch.Tensor:
    """Table ``name`` for ``args`` as a tensor on ``device``, built once.

    Built outside inference mode: the cache outlives its first caller, and
    an inference tensor could not later be saved for a backward pass.
    """
    if name == "hann2d":
        ph, pw = args
        arr = _hann_np(ph)[:, None] * _hann_np(pw)[None, :]
    elif name == "offsets":
        arr = _linspace_np(-SPAN, SPAN, N_UP)
    elif name == "fftfreq":
        arr = np.fft.fftfreq(args[0]).astype(_F32)
    elif name == "arange":
        arr = np.arange(args[0], dtype=np.int64)
    elif name == "window_weights":
        n = args[0]
        arr = np.arange(1, n, dtype=_F32) / _F32(n)
    elif name == "window_index":          # (t, n − 1): i + j + shift
        t, n, shift = args
        arr = (np.arange(t)[:, None] + shift
               + np.arange(n - 1)[None, :]).astype(np.int64)
    elif name == "component_mask":       # (x, y, rotation, scale)
        arr = np.array([1.0, 1.0, *map(float, args)], _F32)
    elif name == "lag_taps":
        arr = _lag_taps_np(*args)[1]
    elif name == "identity_grid":
        arr = _identity_grid_np(*args)
    else:
        raise KeyError(name)
    with torch.inference_mode(False):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


# --- measurement -------------------------------------------------------------

def _parabolic(rm: torch.Tensor, r0: torch.Tensor, rp: torch.Tensor
               ) -> torch.Tensor:
    """Sub-pixel peak refinement: vertex of the parabola through three
    samples, clamped to ±0.5 and guarded against flat neighbourhoods."""
    denom = rm - 2.0 * r0 + rp
    flat = torch.abs(denom) < 1e-12
    safe = torch.where(flat, torch.ones_like(denom), denom)
    d = torch.where(flat, torch.zeros_like(denom), 0.5 * (rm - rp) / safe)
    return torch.clamp(d, -0.5, 0.5)


def _phase_shifts_px(luma: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pair sub-pixel shifts in pixels from phase correlation, and a
    per-pair confidence.

    ``luma``: (..., K, ph, pw) f32, any leading clip axes. Returns
    ``(shifts (..., K-1, 2), conf (..., K-1))``, shifts with last dim
    (Δx, Δy) such that f_t(p) = f_{t-1}(p + Δ); pairs never span two clips.
    ``conf`` is the peak-to-second-peak ratio of the correlation surface,
    the second peak taken outside a ±3-px circular box around the first.

    The Hann-windowed cross-power spectrum, normalized to unit modulus,
    inverse-transforms to a peak at −Δ; the integer peak is refined on a
    1/8-px grid in a ±1.5-px neighbourhood by a small separable DFT
    (complex64 throughout), then by a parabola through the best sample and
    its neighbours.
    """
    ph, pw = luma.shape[-2:]
    dev = luma.device
    f = torch.fft.fft2(luma * _on(dev, "hann2d", ph, pw))
    cross = f[..., 1:, :, :] * torch.conj(f[..., :-1, :, :])
    lead = cross.shape[:-2]                                  # (..., K-1)
    cross = cross.reshape(-1, ph, pw)
    cross = cross / (torch.abs(cross) + 1e-12)               # (P, ph, pw)
    r = torch.fft.ifft2(cross).real
    n_pairs = cross.shape[0]

    flat = r.reshape(n_pairs, ph * pw)
    peak, idx = torch.max(flat, dim=-1)
    iy = torch.div(idx, pw, rounding_mode="floor")
    ix = idx - iy * pw
    ddy = torch.remainder(_on(dev, "arange", ph)[None, :] - iy[:, None]
                          + ph // 2, ph) - ph // 2
    ddx = torch.remainder(_on(dev, "arange", pw)[None, :] - ix[:, None]
                          + pw // 2, pw) - pw // 2
    excl = ((torch.abs(ddy) <= 3)[:, :, None]
            & (torch.abs(ddx) <= 3)[:, None, :])             # (P, ph, pw)
    second = torch.amax(r.masked_fill(excl, -math.inf), dim=(1, 2))
    conf = peak / torch.clamp(second, min=1e-9)
    # Unwrap the circular peak index to a signed integer shift.
    p0y = torch.where(iy > ph // 2, iy - ph, iy).to(torch.float32)
    p0x = torch.where(ix > pw // 2, ix - pw, ix).to(torch.float32)

    o = _on(dev, "offsets")
    fy = _on(dev, "fftfreq", ph)
    fx = _on(dev, "fftfreq", pw)
    ey = torch.exp(2j * math.pi * (p0y[:, None] + o[None, :])[:, :, None]
                   * fy[None, None, :])                      # (P, 25, ph)
    ex = torch.exp(2j * math.pi * fx[None, :, None]
                   * (p0x[:, None] + o[None, :])[:, None, :])  # (P, pw, 25)
    up = torch.bmm(torch.bmm(ey, cross), ex).real            # (P, 25, 25)

    upf = up.reshape(n_pairs, N_UP * N_UP)
    uidx = torch.argmax(upf, dim=-1)
    uy = torch.div(uidx, N_UP, rounding_mode="floor")
    ux = uidx - uy * N_UP

    def at(dy: int, dx: int) -> torch.Tensor:
        yy = torch.clamp(uy + dy, 0, N_UP - 1)
        xx = torch.clamp(ux + dx, 0, N_UP - 1)
        return torch.gather(upf, 1, (yy * N_UP + xx)[:, None])[:, 0]

    step = 2.0 * SPAN / (N_UP - 1)          # 0.125 px
    r0 = at(0, 0)
    sy = _parabolic(at(-1, 0), r0, at(1, 0)) * step
    sx = _parabolic(at(0, -1), r0, at(0, 1)) * step
    # The correlation peak sits at −Δ.
    shifts = torch.stack([-(p0x + o[ux] + sx), -(p0y + o[uy] + sy)], dim=-1)
    return shifts.reshape(*lead, 2), conf.reshape(lead)


def measure_shifts(seq: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-step camera translation deltas from consecutive frame pairs.

    ``seq``: (..., K, mh, mw, C) f32 model-resolution frames centred at 0,
    any leading clip axes. Returns ``(deltas (..., K-1, 2), conf
    (..., K-1))``: deltas in normalized grid
    units (align_corners convention, last dim (x, y)), delta[k] =
    a_{k+1} − a_k where frame i is the scene through a camera translated
    by a_i; conf is the full-frame measurement confidence.
    """
    mh, mw = seq.shape[-3:-1]
    luma = seq.to(torch.float32).mean(dim=-1)              # (..., K, mh, mw)
    d, conf = _phase_shifts_px(luma)
    scale = torch.stack([d[..., 0] * (2.0 / max(mw - 1, 1)),
                         d[..., 1] * (2.0 / max(mh - 1, 1))], dim=-1)
    return scale, conf


def measure_motion(seq: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-step camera (Δx, Δy, Δθ, Δlog-s) from consecutive frame pairs,
    and the full-frame confidence.

    Translation from full-frame phase correlation; rotation and scale from
    the differential translation of half-frame patches — rotation is their
    curl, scale their divergence:

        δθ ≈ ((dyR − dyL)/Δx_lr + (dxT − dxB)/Δy_tb) / 2
        δs ≈ ((dxR − dxL)/Δx_lr + (dyB − dyT)/Δy_tb) / 2
    """
    mh, mw = seq.shape[-3:-1]
    luma = seq.to(torch.float32).mean(dim=-1)
    txy, conf = measure_shifts(seq)                        # (..., K-1, 2)

    half_w, half_h = mw // 2, mh // 2
    d_l, _ = _phase_shifts_px(luma[..., :half_w])
    d_r, _ = _phase_shifts_px(luma[..., mw - half_w:])
    d_t, _ = _phase_shifts_px(luma[..., :half_h, :])
    d_b, _ = _phase_shifts_px(luma[..., mh - half_h:, :])

    # Half-centre separations in normalized units.
    sep_x = half_w * 2.0 / max(mw - 1, 1)      # left ↔ right centres
    sep_y = half_h * 2.0 / max(mh - 1, 1)      # top ↔ bottom centres
    dy_lr = (d_r[..., 1] - d_l[..., 1]) * (2.0 / max(mh - 1, 1))
    dx_tb = (d_t[..., 0] - d_b[..., 0]) * (2.0 / max(mw - 1, 1))
    dtheta = 0.5 * (dy_lr / sep_x + dx_tb / sep_y)
    dx_lr = (d_r[..., 0] - d_l[..., 0]) * (2.0 / max(mw - 1, 1))
    dy_tb = (d_b[..., 1] - d_t[..., 1]) * (2.0 / max(mh - 1, 1))
    dscale = 0.5 * (dx_lr / sep_x + dy_tb / sep_y)
    return torch.cat([txy, dtheta[..., None], dscale[..., None]],
                     dim=-1), conf


def measure(cfg: StabilizeConfig, seq: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pair (..., K-1, 4) deltas and confidence for the config's
    enabled components; a disabled component's deltas are zero."""
    want_rot = cfg.path_smooth_rotation
    want_scale = cfg.path_smooth_scale
    if want_rot or want_scale:
        deltas, conf = measure_motion(seq)             # (..., K-1, 4)
        deltas = deltas * _on(seq.device, "component_mask", want_rot,
                              want_scale)
    else:
        d2, conf = measure_shifts(seq)
        deltas = torch.cat([d2, torch.zeros_like(d2)], dim=-1)
    return deltas, conf


# --- correction ----------------------------------------------------------------

def _weighted_sum(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Σ_m x[..., t, m, c]·w[m] → (..., t, c), one clip at a time and, on
    the card, in calls of CHUNK_GROUP frames: a contraction sums in an
    order that depends on its size, and a frame's output must depend
    neither on the clips batched with it nor on the chunk size."""
    if x.dim() == 3:
        return in_groups(lambda v: torch.einsum("tmc,m->tc", v, w), x,
                         CHUNK_GROUP)
    return torch.stack([_weighted_sum(xi, w) for xi in x])


def _window_rel(deltas: torch.Tensor, t: int, n: int, shift: int
                ) -> torch.Tensor:
    """P_g − Ā_g for each of ``t`` frames: the weighted sum (weights
    (1..n−1)/n) of deltas[..., i + shift .. i + shift + n − 2, :]."""
    dev = deltas.device
    idx = _on(dev, "window_index", t, n, shift)            # (t, n − 1)
    w = _on(dev, "window_weights", n)                      # (n − 1,)
    return _weighted_sum(deltas[..., idx, :], w)


def smoothed_corrections(cfg: StabilizeConfig, deltas: torch.Tensor,
                         t: int, state: torch.Tensor,
                         cuts: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-frame extra offset e_t = S_t − Ā_t and the updated state.

    Args:
      cfg: pipeline config (path_smooth > 0).
      deltas: (..., t + window − 2, C) inter-frame deltas over the chunk's
        model-resolution sequence (halo + current frames), any leading
        clip axes.
      t: output frames in the chunk.
      state: (..., C) f32 carried D = P − S from the previous chunk.
      cuts: optional (..., t + window − 2) bool aligned with ``deltas``: a
        detected scene cut at that transition resets the EMA (D := rel,
        so e = 0 at the cut frame).

    Returns (e (..., t, C) f32, new_state (..., C)). With α = 2/(L+1):

      D_g = (1−α)(D_{g−1} + δ_g);  e_g = clamp((P_g − Ā_g) − D_g);
      D_g := (P_g − Ā_g) − e_g   (anti-windup)

    A loop of small elementwise tensor operations over the t frames (so
    each clip's values do not depend on its co-travellers); nothing is read
    back to the host.
    """
    n = cfg.model.window
    one_minus_alpha = float(_F32(1.0) - _F32(2.0 / (cfg.path_smooth + 1.0)))
    clamp = float(_F32(cfg.path_smooth_max))
    deltas = deltas.to(torch.float32)
    rel = _window_rel(deltas, t, n, 0)                     # (..., t, C)
    # δ_g for output frame i is deltas[i + n − 2]: the halo → first-frame
    # transition for i = 0, so each global delta is consumed once.
    step_deltas = deltas[..., n - 2:n - 2 + t, :]
    step_cuts = None if cuts is None else cuts[..., n - 2:n - 2 + t, None]
    d = state.to(torch.float32)
    es = []
    for i in range(t):
        d = one_minus_alpha * (d + step_deltas[..., i, :])
        if step_cuts is not None:
            # restart (e = 0)
            d = torch.where(step_cuts[..., i, :], rel[..., i, :], d)
        e = torch.clamp(rel[..., i, :] - d, -clamp, clamp)
        d = rel[..., i, :] - e          # anti-windup: absorb the clamp
        es.append(e)
    return torch.stack(es, dim=-2), d


def corrections_from_measured(cfg: StabilizeConfig, deltas: torch.Tensor,
                              conf: torch.Tensor, t: int,
                              state: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Confidence gating and the EMA: (deltas, conf) → (e, state)."""
    cuts = None
    if cfg.path_smooth_conf > 0:
        # A pair whose correlation peak is not clearly dominant (scene cut,
        # flat stretch, occlusion) contributes no delta.
        ok = conf >= float(_F32(cfg.path_smooth_conf))
        deltas = deltas * ok[..., None].to(deltas.dtype)
        if cfg.path_smooth_cut > 0:
            cuts = conf < float(_F32(cfg.path_smooth_cut))
    return smoothed_corrections(cfg, deltas, t, state, cuts=cuts)


def apply_corrections(cfg: StabilizeConfig, offsets: torch.Tensor,
                      e: torch.Tensor) -> torch.Tensor:
    """Add the per-frame correction fields e (..., C) to the coarse
    offsets (..., gh, gw, 2): the translation as a constant, rotation as
    e_θ·(−Y, X) and scale as e_s·(X, Y) at the control points — linear
    fields, exact under the bilinear upsample."""
    gh, gw = offsets.shape[-3:-1]
    out = offsets + e[..., None, None, :2].to(offsets.dtype)
    g = _on(offsets.device, "identity_grid", gh, gw)        # (gh, gw, 2)
    if cfg.path_smooth_rotation:
        rot = torch.stack([-g[..., 1], g[..., 0]], dim=-1)
        out = out + (e[..., 2, None, None, None]
                     * rot).to(offsets.dtype)
    if cfg.path_smooth_scale:
        out = out + (e[..., 3, None, None, None]
                     * g).to(offsets.dtype)
    return out


def apply_path_smoothing(cfg: StabilizeConfig, seq: torch.Tensor,
                         offsets: torch.Tensor, state: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """offsets (..., T, gh, gw, 2) → smoothed offsets, and the new state.

    ``cfg.strength`` scales the CNN's window-relative correction only; the
    sway correction e = S − Ā is always applied in full (the clamp and the
    auto-crop margin assume |e| ≤ path_smooth_max).
    """
    t = offsets.shape[-4]
    deltas, conf = measure(cfg, seq)
    e, new_state = corrections_from_measured(cfg, deltas, conf, t, state)
    return apply_corrections(cfg, offsets, e), new_state


# --- fixed lag -------------------------------------------------------------------

def lag_carry_len(cfg: StabilizeConfig) -> int:
    """Measurement-window entries carried between chunks in lag mode."""
    k_past, _ = _lag_taps_np(cfg.path_smooth, cfg.path_smooth_lag,
                             cfg.model.window)
    return k_past + cfg.path_smooth_lag - (cfg.model.window - 1)


def lag_corrections(cfg: StabilizeConfig, deltas_ext: torch.Tensor,
                    conf_ext: torch.Tensor, t: int) -> torch.Tensor:
    """Per-frame corrections e (..., t, C) of the lag mode.

    ``deltas_ext``/``conf_ext``: the extended measurement window (t + K +
    D − 1 entries along the axis before C, any leading clip axes) =
    carried entries ++ this chunk's; emitted frame i's
    transition entries sit at [i, i + K + D − 1] and its window-mean
    entries at [i + K − window + 1, i + K − 1]. S_g − P_g = Σ_k c_k·δ_{g+k}
    with the fixed taps c, so e_g = clamp(rel_g + Σ c·δ).
    """
    n = cfg.model.window
    key = (cfg.path_smooth, cfg.path_smooth_lag, n)
    k_past, taps = _lag_taps_np(*key)
    clamp = float(_F32(cfg.path_smooth_max))
    deltas_ext = deltas_ext.to(torch.float32)
    if cfg.path_smooth_conf > 0:
        ok = conf_ext >= float(_F32(cfg.path_smooth_conf))
        deltas_ext = deltas_ext * ok[..., None].to(deltas_ext.dtype)
    dev = deltas_ext.device
    rel = _window_rel(deltas_ext, t, n, k_past - n + 1)
    f_idx = _on(dev, "window_index", t, len(taps) + 1, 0)  # (t, len(taps))
    fir = _weighted_sum(deltas_ext[..., f_idx, :],
                        _on(dev, "lag_taps", *key))
    return torch.clamp(rel + fir, -clamp, clamp)
