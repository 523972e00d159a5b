"""Semantic class palettes for the logger's images (a copy of
super_tpu/utils/labels.py, numpy).

The Semantic-SuPer classes (Beef / Chicken / Tool) and the superv1
binary tissue palette; ``seg_to_color`` chooses between them by dataset.
"""

from __future__ import annotations

import numpy as np

# Semantic-SuPer classes: id -> RGB in [0, 1].
SEMANTIC_CLASSES = ("Beef", "Chicken", "Tool")
ID2COLOR = np.array(
    [[0, 0, 0], [50, 50, 50], [150, 150, 150]], dtype=np.float32) / 255.0

# superv1 binary tissue palette.
BINARY_ID2COLOR = np.array(
    [[50, 50, 50], [255, 255, 255]], dtype=np.float32) / 255.0


def seg_to_color(seg: np.ndarray, data: str = "superv2") -> np.ndarray:
    """(H, W) labels -> (3, H, W) RGB image."""
    pal = BINARY_ID2COLOR if data == "superv1" else ID2COLOR
    idx = np.clip(seg, 0, len(pal) - 1)
    return pal[idx].transpose(2, 0, 1)
