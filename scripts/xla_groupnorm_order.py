"""The order in which XLA's CPU backend sums a GroupNorm statistic, read
from the LLVM IR it emits, held against XLA itself.

    XLA_FLAGS=--xla_dump_to=DIR python scripts/xla_groupnorm_order.py

(the flag writes each jitted function's optimized HLO,
``*.cpu_after_optimizations.txt``, and its LLVM IR, ``*.ir-with-opt.ll``;
the script runs without it.)

The reference's bf16 GroupNorm sums ``x.reshape(n, h, w, g, c // g)`` over
axes (1, 2, 4) in f32. Where XLA keeps that reduce as one loop fusion (the
narrow model's shapes), the IR is a loop over the rows ``h``; in each row
LLVM vectorizes the ``w`` loop eight lanes wide (lane ``l`` takes ``w = 8b +
l``), adding the group's channels in order into each lane, block by block,
with the running total entering lane 0; ``llvm.vector.reduce.fadd``
(``reassoc``) then sums the lanes by halving (``vextractf128``,
``vshufpd``, ``vmovshdup``): ((v0+v4)+(v2+v6)) + ((v1+v5)+(v3+v7)).
``emulate`` is that order in numpy. Larger shapes are rewritten first (a
reduce-window of 32 along the reduced axes, then a reduce), so their order
is another one. Prints, per shape, the share of sums that the emulation
gets bit for bit.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

GROUPS = 8
# The narrow model's GroupNorm inputs (base 8 features, 32x32 frames) and
# the presets' (base 32, 128x128 and 256x256 frames).
SHAPES = ((4, 16, 16, 16), (4, 8, 8, 32), (2, 64, 64, 32), (2, 32, 32, 64),
          (2, 16, 16, 128), (1, 128, 128, 32))


def xla_sum(x: np.ndarray, g: int) -> np.ndarray:
    n, h, w, c = x.shape
    f = jax.jit(lambda a: jnp.sum(a.reshape(n, h, w, g, c // g),
                                  axis=(1, 2, 4)))
    return np.asarray(f(jnp.asarray(x)))


def emulate(x: np.ndarray, g: int, lanes: int = 8) -> np.ndarray:
    """The (n, g) sums in the order of the IR (module docstring)."""
    n, h, w, c = x.shape
    xr = x.reshape(n, h, w // lanes, lanes, g, c // g)
    total = np.zeros((n, g), np.float32)
    for r in range(h):
        v = np.zeros((n, g, lanes), np.float32)
        v[..., 0] = total
        for b in range(w // lanes):
            for k in range(c // g):
                v = v + xr[:, r, b, :, :, k].transpose(0, 2, 1)
        v = v[..., :4] + v[..., 4:]
        v = v[..., :2] + v[..., 2:]
        total = v[..., 0] + v[..., 1]
    return total


def main() -> None:
    rng = np.random.default_rng(0)
    for shape in SHAPES:
        x = rng.standard_normal(shape).astype(np.float32)
        x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16)
                       .astype(jnp.float32))
        got, want = emulate(x, GROUPS), xla_sum(x, GROUPS)
        print(f"{shape}, {GROUPS} groups: {100 * float((got == want).mean()):.1f} "
              f"% of the sums bit for bit, worst "
              f"{float(np.abs(got - want).max() / np.abs(want).max()):.2e} "
              "of the largest")


if __name__ == "__main__":
    main()
