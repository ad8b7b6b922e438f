"""Image <-> block-tensor reshapes.

The reference walks row-pointer views over the image buffer per block
(ImageBase.cpp:175-241).  The device formulation is a pure layout
transform: an [H, W] image becomes an [N, B, B] tile tensor (row-major block
order, matching the reference's block emission order) with one reshape +
transpose, which XLA lowers to a copy at worst.
"""

from __future__ import annotations


def blockify(img, block: int):
    """[H, W] -> [N, B, B] in row-major block order (reference block order)."""
    h, w = img.shape
    assert h % block == 0 and w % block == 0, (h, w, block)
    by, bx = h // block, w // block
    return img.reshape(by, block, bx, block).swapaxes(1, 2).reshape(by * bx, block, block)


def deblockify(blocks, h: int, w: int):
    """[N, B, B] -> [H, W], inverse of :func:`blockify`."""
    n, b, b2 = blocks.shape
    assert b == b2
    by, bx = h // b, w // b
    assert n == by * bx
    return blocks.reshape(by, bx, b, b).swapaxes(1, 2).reshape(h, w)
