"""PWC-Net as the stabilizer's motion estimator, in plain PyTorch and
float32: the equations of the ``pwc`` arch, written from PWC-Net's
``PWCDCNet`` (Sun, Yang, Liu and Kautz, CVPR 2018, arXiv:1709.02371;
github.com/NVlabs/PWC-Net, ``PyTorch/models/PWCNet.py``).

A frame's pyramid: for l = 1..6 (widths 16, 32, 64, 96, 128, 196) a
stride-2 3x3 conv and two 3x3 convs, each followed by LeakyReLU(0.1),
every conv padded symmetrically by 1. A pair (a, b) of pyramids gives the
flow a → b coarse to fine: at level 6 x = φ(corr(a6, b6)); below it b is
warped by the upsampled flow times 20 / 2^l and x = cat(φ(corr(a_l,
warp(b_l))), a_l, up_flow, up_feat); five dense convs (128, 128, 96, 64,
32) each prepend their output to x; a conv predicts the flow; above level
2 two 4x4 stride-2 transposed convs upsample the flow and x to 2
channels each. At level 2 the dilated context network (dilations 1, 2,
4, 8, 16, 1) adds its refinement to the flow.

corr(a, b) holds, for |dy|, |dx| <= r, channel (dy + r)(2r + 1) + dx + r:
the channel mean of a(p) b(p + (dy, dx)), b zero outside the map. It is
computed here shift by shift over the overlapping region, not by the
port's function. warp is NVlabs' ``warp``: bilinear sampling at p +
flow(p), align-corners coordinates, zero outside, times the mask of
samples whose taps all lie inside.

The head is the stabilizer's, not PWC-Net's: each of the window's N - 1
earlier frames is paired with its last (the reference), each flow is
average-pooled 4 x 4 onto the grid, and the 2 (N - 1) channels, then
the reference's level-4 features, go through the corr arch's head (3x3
SAME convs to 128, GELU, 128, GELU, 2, tanh times ``max_offset``).

Parameters are keyed by the port's state-dict names, in its layouts
(conv kernels OIHW, transposed-conv kernels (in, out, 4, 4)). The caller
keeps TF32 off in cuDNN and cuBLAS (``drivers/stream.py::reference_u8``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference import cnn
from portbench.reference import train as ref_train
from portbench.reference.stream import dense_grid, warp as frame_warp

WIDTHS = (16, 32, 64, 96, 128, 196)
DENSE = (128, 128, 96, 64, 32)
CONTEXT = ((128, 1), (128, 2), (128, 4), (96, 8), (64, 16), (32, 1))
HEAD_LEVEL = 4
# The corr rule's truncated normal: (-2, 2) sigma, divided by the
# truncated draw's standard deviation so its variance is 1 / fan_in.
TRUNC_STD = 0.87962566103423978


def encoder_names(level: int) -> tuple:
    if level == 6:
        return ("conv6aa", "conv6a", "conv6b")
    return (f"conv{level}a", f"conv{level}aa", f"conv{level}b")


def shapes(cfg: dict) -> dict:
    """Every parameter's shape by its name, for the model config dict."""
    r = cfg["corr_radius"]
    nd = (2 * r + 1) ** 2
    out = {}

    def conv(name, cin, cout, k=3):
        out[name + ".weight"] = (cout, cin, k, k)
        out[name + ".bias"] = (cout,)

    cin = cfg["channels"]
    for level, width in enumerate(WIDTHS, 1):
        for name in encoder_names(level):
            conv("encoder." + name, cin, width)
            cin = width
    for level in range(6, 1, -1):
        cin = nd if level == 6 else nd + WIDTHS[level - 1] + 4
        for i, width in enumerate(DENSE):
            conv(f"conv{level}_{i}", cin, width)
            cin += width
        conv(f"predict_flow{level}", cin, 2)
        if level > 2:
            out[f"deconv{level}.weight"] = (2, 2, 4, 4)
            out[f"deconv{level}.bias"] = (2,)
            out[f"upfeat{level}.weight"] = (cin, 2, 4, 4)
            out[f"upfeat{level}.bias"] = (2,)
    for i, (width, _) in enumerate(CONTEXT, 1):
        conv(f"dc_conv{i}", cin, width)
        cin = width
    conv("dc_conv7", cin, 2)
    head_in = 2 * (cfg["window"] - 1) + WIDTHS[HEAD_LEVEL - 1]
    conv("head_conv1", head_in, 128)
    conv("head_conv2", 128, 128)
    conv("head_out", 128, 2)
    return out


def init(cfg: dict, seed: int) -> dict:
    """Seeded weights (CPU, float32): PWC-Net's convs and transposed convs
    as NVlabs draws them (Kaiming normal, fan_in, gain sqrt(2); PyTorch's
    fan_in of a transposed conv's (in, out, k, k) kernel is out k^2),
    every bias zero; the head's three convs, ``head_out`` included,
    truncated normal with variance 1 / fan_in."""
    gen = torch.Generator().manual_seed(int(seed) & ((1 << 63) - 1))
    out = {}
    for name, shape in shapes(cfg).items():
        if name.endswith(".bias"):
            out[name] = torch.zeros(shape)
            continue
        fan_in = shape[1] * shape[2] * shape[3]
        if name.startswith("head_"):
            std = math.sqrt(1.0 / fan_in) / TRUNC_STD
            w = torch.empty(shape)
            torch.nn.init.trunc_normal_(w, std=std, a=-2.0 * std,
                                        b=2.0 * std, generator=gen)
        else:
            w = torch.randn(shape, generator=gen) * math.sqrt(2.0 / fan_in)
        out[name] = w
    return out


def leaky(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, 0.1 * x)


def conv(p: dict, name: str, x: torch.Tensor, stride: int = 1,
         dilation: int = 1) -> torch.Tensor:
    return F.conv2d(x, p[name + ".weight"], p[name + ".bias"], stride,
                    dilation, dilation)


def deconv(p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.conv_transpose2d(x, p[name + ".weight"], p[name + ".bias"],
                              stride=2, padding=1)


def pyramid(p: dict, frames: torch.Tensor) -> list:
    """NCHW frames → [c1, ..., c6]."""
    levels, x = [], frames
    for level in range(1, 7):
        for i, name in enumerate(encoder_names(level)):
            x = leaky(conv(p, "encoder." + name, x, 2 if i == 0 else 1))
        levels.append(x)
    return levels


def corr(a: torch.Tensor, b: torch.Tensor, r: int) -> torch.Tensor:
    """(P, C, H, W) x 2 → (P, (2r+1)^2, H, W): per shift, the channel mean
    of the products over the region where both maps are defined."""
    n, c, h, w = a.shape
    out = a.new_zeros((n, (2 * r + 1) ** 2, h, w))
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            y0, y1 = max(0, -dy), min(h, h - dy)
            x0, x1 = max(0, -dx), min(w, w - dx)
            if y1 <= y0 or x1 <= x0:
                continue
            prod = (a[:, :, y0:y1, x0:x1]
                    * b[:, :, y0 + dy:y1 + dy, x0 + dx:x1 + dx])
            out[:, (dy + r) * (2 * r + 1) + dx + r, y0:y1, x0:x1] = \
                prod.sum(dim=1) / c
    return out


def warp(x: torch.Tensor, flo: torch.Tensor) -> torch.Tensor:
    """NVlabs' ``warp``: x (B, C, H, W) at p + flo(p), flo (B, 2, H, W)."""
    b, c, h, w = x.shape
    xx = torch.arange(w, device=x.device).view(1, -1).repeat(h, 1)
    yy = torch.arange(h, device=x.device).view(-1, 1).repeat(1, w)
    grid = torch.stack([xx, yy])[None].float()
    vgrid = grid + flo
    vx = 2.0 * vgrid[:, 0] / max(w - 1, 1) - 1.0
    vy = 2.0 * vgrid[:, 1] / max(h - 1, 1) - 1.0
    vgrid = torch.stack([vx, vy], dim=-1)
    out = F.grid_sample(x, vgrid, align_corners=True)
    mask = F.grid_sample(torch.ones_like(x), vgrid, align_corners=True)
    mask = (mask >= 0.9999).float()
    return out * mask


def flow(p: dict, cfg: dict, a: list, b: list, warps: bool = True,
         context: bool = True) -> torch.Tensor:
    """PWC-Net's level-2 flow a → b of P pairs of pyramids ([c1..c6], each
    (P, C, H, W)) → (P, 2, H2, W2). ``warps`` and ``context`` off leave
    out the feature warps (a zero flow) and the context network."""
    r = cfg["corr_radius"]
    up_flow = up_feat = None
    for level in range(6, 1, -1):
        al, bl = a[level - 1], b[level - 1]
        if up_flow is None:
            x = leaky(corr(al, bl, r))
        else:
            moved = up_flow * (20.0 / 2 ** level) if warps else \
                torch.zeros_like(up_flow)
            x = torch.cat([leaky(corr(al, warp(bl, moved), r)), al,
                           up_flow, up_feat], dim=1)
        for i in range(len(DENSE)):
            x = torch.cat([leaky(conv(p, f"conv{level}_{i}", x)), x], dim=1)
        fl = conv(p, f"predict_flow{level}", x)
        if level > 2:
            up_flow = deconv(p, f"deconv{level}", fl)
            up_feat = deconv(p, f"upfeat{level}", x)
    if not context:
        return fl
    for i, (_, dil) in enumerate(CONTEXT, 1):
        x = leaky(conv(p, f"dc_conv{i}", x, dilation=dil))
    return fl + conv(p, "dc_conv7", x)


def head_conv(p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.conv2d(x, p[name + ".weight"], p[name + ".bias"], padding=1)


def window_offsets(p: dict, cfg: dict, seq: torch.Tensor, t: int,
                   **faults) -> torch.Tensor:
    """Offsets (t, gh, gw, 2) of the t windows of a (t + N - 1)-frame
    model-resolution sequence (NHWC): window i is frames i .. i + N - 1,
    its reference frame i + N - 1. ``faults`` go to ``flow``."""
    n = cfg["window"]
    pyr = pyramid(p, seq.permute(0, 3, 1, 2))
    out = []
    for i in range(t):
        ref = i + n - 1
        x = pyr[HEAD_LEVEL - 1][ref:ref + 1]
        if n > 1:
            a = [lv[ref:ref + 1].expand(n - 1, -1, -1, -1) for lv in pyr]
            b = [lv[i:ref] for lv in pyr]
            fl = F.avg_pool2d(flow(p, cfg, a, b, **faults), 4)
            x = torch.cat([fl.reshape(1, -1, *fl.shape[2:]), x], dim=1)
        x = cnn.gelu(head_conv(p, "head_conv1", x))
        x = cnn.gelu(head_conv(p, "head_conv2", x))
        x = torch.tanh(head_conv(p, "head_out", x)) * cfg["max_offset"]
        out.append(x.permute(0, 2, 3, 1))
    return torch.cat(out)


def loss(p: dict, cfg: dict, batch, weights: dict):
    """(total, terms) of a rendered batch (``reference/train.py::render``)
    through this model; differentiable in ``p``. The terms are those of
    ``reference/train.py::loss``."""
    inputs, lasts, targets, t_offs = batch
    mh, mw = cfg["model_size"]
    b, s = lasts.shape[:2]
    offsets = torch.cat([window_offsets(p, cfg, inputs[k], s)
                         for k in range(b)])
    warped = frame_warp(lasts.flatten(0, 1), dense_grid(offsets, mh, mw))
    warped = warped.reshape(b, s, *warped.shape[1:])
    bh, bw = int(mh * ref_train.LOSS_BORDER), int(mw * ref_train.LOSS_BORDER)
    terms = {"pixel": ((warped - targets)[:, :, bh:mh - bh, bw:mw - bw]
                       ** 2).mean()}
    offs = offsets.reshape(b, s, *offsets.shape[1:])
    terms["offset"] = ((offs - t_offs) ** 2).mean()
    terms["smooth"] = ((offs[:, 1:] - offs[:, :-1]) ** 2).mean()
    terms["reg"] = (offsets ** 2).mean()
    total = sum(weights[k] * terms[k] for k in ("pixel", "offset", "smooth",
                                               "reg"))
    return total, terms
