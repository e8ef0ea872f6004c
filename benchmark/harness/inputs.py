"""The inputs of a run, made on the host from its seed.

Every image of a ring is seeded uniform uint8 noise of the
configuration's shape: an integer stencil's cost does not depend on the
pixels, and noise leaves no flat region where a wrong answer could hide.
The same (configuration, seed, count) gives the same bytes in any
process.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def image_shape(config: dict) -> Tuple[int, ...]:
    """(H, W) for one channel, else (H, W, C)."""
    h, w, c = config["height"], config["width"], config["channels"]
    return (h, w) if c == 1 else (h, w, c)


def ring(config: dict, seed: int, n: int) -> List[np.ndarray]:
    """``n`` seeded images of the configuration's shape."""
    rng = np.random.default_rng([seed, 0x5EED])
    shape = image_shape(config)
    block = rng.integers(0, 256, size=(n,) + shape, dtype=np.uint8)
    return [block[i] for i in range(n)]


def megapixels(config: dict) -> float:
    """Output megapixels of one image (H x W, whatever the channels)."""
    return config["height"] * config["width"] / 1e6
