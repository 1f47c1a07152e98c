"""Sliding-window inference, re-exported from ``supernet_tpu.tiling``: it is
host-side numpy around any batched ``predict`` callable and imports no JAX."""

from supernet_tpu.tiling import (  # noqa: F401
    output_margins,
    predict_image,
    predict_tiled,
    predict_volume,
    tile_positions,
)
