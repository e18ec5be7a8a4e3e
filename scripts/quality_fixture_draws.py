#!/usr/bin/env python
"""Write the random draws of the quality table's fixtures.

scripts/quality_table.py renders its fixtures from ``jax.random`` draws;
the stability gates of tests/test_quality_table.py were set on exactly
those clips, and other draws of the same distributions miss them (the
reference's own stabilizer misses the sway and handheld gates on clips
rendered from seeded torch generators). So the PyTorch port's table
(scripts/quality_table_torch.py), which imports no JAX, renders the same
clips from these draws: the four uniform noise octaves of the still
(``jax.random.key(11)``) and the handheld path's normal steps and uniform
magnitudes (``jax.random.key(4)``, 64 frames). The sway fixtures' paths are
numpy draws, which the port makes itself.

    python scripts/quality_fixture_draws.py   (writes quality_fixture_draws.npz
                                               beside this script)
"""
import os
import sys

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "quality_fixture_draws.npz")
OCTAVES = (4, 8, 16, 64)          # the still's octave resolutions
FRAMES = 64


def draws() -> dict:
    import jax
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    key = jax.random.key(11)
    out = {f"still_octave{i}": np.asarray(jax.random.uniform(
        jax.random.fold_in(key, i), (res, res, 3)))
        for i, res in enumerate(OCTAVES)}
    k1, k2 = jax.random.split(jax.random.key(4))
    out["handheld_steps"] = np.asarray(jax.random.normal(k1, (FRAMES + 8,
                                                              5)))
    out["handheld_mag"] = np.asarray(jax.random.uniform(
        k2, (5,), minval=0.3, maxval=1.0))
    return out


def main() -> int:
    import numpy as np
    np.savez(PATH, **draws())
    print(f"wrote {PATH}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
