"""Device-mesh construction for multi-chip codec sharding.

The reference's only parallelism is OpenMP threads over blocks inside one
process (SURVEY §2 #22).  The device design replaces it with a 2-D
`jax.sharding.Mesh`:

  * axis "frame": data parallelism over frames / GOPs (every GOP starts with
    an I-frame, VideoBase.hpp:32, so GOPs are fully independent — the natural
    DP unit),
  * axis "block": spatial parallelism over block rows within one frame
    (the reference's OpenMP-over-blocks analogue; needs merange-wide halo
    exchange for motion search — neighbour ppermutes).

The mesh follows the algorithm only: devices are taken in order, since the
cards of one host reach each other at the same rate.

Still images use the same mesh with frame=1 (or fold both axes into blocks).
"""

from __future__ import annotations

import math

import jax
from jax.sharding import Mesh


def make_mesh(n_devices: int | None = None, frame_axis: int | None = None,
              devices=None) -> Mesh:
    """Build a ("frame", "block") mesh over the first ``n_devices`` devices.

    ``frame_axis`` fixes the frame-parallel extent; by default the mesh is
    factored as close to square as possible with frame >= block.
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = devices[:n_devices]
    if frame_axis is None:
        frame_axis = 1
        for f in range(int(math.isqrt(n_devices)), 0, -1):
            if n_devices % f == 0:
                frame_axis = max(f, n_devices // f)
                break
    assert n_devices % frame_axis == 0, (n_devices, frame_axis)
    import numpy as np

    grid = np.asarray(devices).reshape(frame_axis, n_devices // frame_axis)
    return Mesh(grid, axis_names=("frame", "block"))
