"""The plain reference with its trunk computed below bf16's precision: the
control of a bf16 cell's ``correct``.

Inside ``rounded_trunk()`` the reference's encoder (``cnn.encode``) rounds
each conv output, each GroupNorm output and each GELU output to
``MANTISSA_BITS`` explicit mantissa bits (bf16 keeps 7), to nearest with
ties to even, and rounds each one's gradient the same way in the
backward. Everything else stays the reference's float32: the frames, the
correlation and the head, the loss, the gradients' sums, AdamW. The
reference's functions are wrapped, not edited.
"""

from __future__ import annotations

import contextlib
import types

import torch

from portbench.reference import cnn

MANTISSA_BITS = 4


def round_mantissa(x: torch.Tensor, bits: int = MANTISSA_BITS
                   ) -> torch.Tensor:
    """Float32 ``x`` rounded to ``bits`` explicit mantissa bits, to nearest
    with ties to even (an overflow rounds to infinity)."""
    drop = 23 - bits
    i = x.contiguous().view(torch.int32)
    i = (i + ((1 << (drop - 1)) - 1) + ((i >> drop) & 1)) & -(1 << drop)
    return i.view(torch.float32)


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return round_mantissa(x)

    @staticmethod
    def backward(ctx, g):
        return round_mantissa(g)


def _rounded(fn):
    def wrapped(*args, **kwargs):
        return _Round.apply(fn(*args, **kwargs))
    return wrapped


# cnn.encode with the module's conv, group_norm and gelu seen rounded; the
# head keeps cnn's own functions.
_ENCODE = types.FunctionType(
    cnn.encode.__code__,
    dict(vars(cnn), conv=_rounded(cnn.conv),
         group_norm=_rounded(cnn.group_norm), gelu=_rounded(cnn.gelu)),
    "encode")


@contextlib.contextmanager
def rounded_trunk():
    """While the block runs, the reference encodes with the rounded trunk
    (``portbench/reference/train.py`` calls ``cnn.encode``)."""
    plain = cnn.encode
    cnn.encode = _ENCODE
    try:
        yield
    finally:
        cnn.encode = plain
