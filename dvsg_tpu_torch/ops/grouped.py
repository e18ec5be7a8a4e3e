"""Calls of a fixed size for the per-frame stages of a chunk step on the
card.

cuBLAS, cuDNN and PyTorch's reductions pick their kernels, and with them
the order of their sums, by the size of a call, so a frame's bytes would
depend on how many frames share its call: on the chunk size T and on the
clips batched with it. On a CUDA tensor those stages therefore run in
calls of exactly ``size`` rows, a short last call padded with copies of its
last row: ``CHUNK_GROUP`` = one T = 16 chunk's frames (the resize, the
head, the smoothing stage's weighted sums), ``ENCODE_GROUP`` = its
T + window − 1 = 20 frames for the encoder of a window-5 model. The CPU's
kernels give a row the same bytes whatever the call's size, so there each
stage makes one call.
"""

from __future__ import annotations

from typing import Optional

import torch

CHUNK_GROUP = 16
ENCODE_GROUP = 20


def in_groups(fn, x: torch.Tensor, size: int,
              grouped: Optional[bool] = None) -> torch.Tensor:
    """``fn`` over the leading axis of ``x`` in calls of exactly ``size``
    rows; by default on a CUDA tensor only, in one call on the CPU."""
    n = x.shape[0]
    if not (x.is_cuda if grouped is None else grouped):
        return fn(x)
    pad = -n % size
    if pad:
        x = torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
    outs = [fn(x[i:i + size]) for i in range(0, n + pad, size)]
    return (outs[0] if len(outs) == 1 else torch.cat(outs))[:n]
