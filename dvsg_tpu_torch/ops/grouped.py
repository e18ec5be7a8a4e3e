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


def each(fn, x):
    """``fn`` over a tensor, or over each tensor of a tuple (the pwc arch's
    pyramid levels), keeping the structure."""
    return tuple(fn(t) for t in x) if isinstance(x, tuple) else fn(x)


def in_groups(fn, x, size: int, grouped: Optional[bool] = None):
    """``fn`` over the leading axis of ``x`` in calls of exactly ``size``
    rows; by default on a CUDA tensor only, in one call on the CPU. ``x``
    and what ``fn`` returns may each be a tensor or a tuple of tensors
    with one leading axis (the pwc arch's pyramid)."""
    first = x[0] if isinstance(x, tuple) else x
    n = first.shape[0]
    if not (first.is_cuda if grouped is None else grouped):
        return fn(x)
    pad = -n % size
    if pad:
        x = each(lambda t: torch.cat([t, t[-1:].expand(pad, *t.shape[1:])]),
                 x)
    outs = [fn(each(lambda t: t[i:i + size], x))
            for i in range(0, n + pad, size)]
    if len(outs) > 1:
        outs = [tuple(torch.cat(level) for level in zip(*outs))
                if isinstance(outs[0], tuple) else torch.cat(outs)]
    return each(lambda t: t[:n], outs[0])
