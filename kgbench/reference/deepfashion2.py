"""DeepFashion2's keypoint layout, as its benchmark defines it: 13 garment
classes, each owning a slice of one 294-keypoint vector, and each class's
left/right keypoint pairs, which a horizontal flip swaps (Ge et al.,
"DeepFashion2", CVPR 2019; the dataset's own definition, kept here apart
from the program's copy)."""
from __future__ import annotations

NUM_KEYPOINTS = 294

# Per-class [start, end) slice into the unified 294-keypoint vector,
# keyed by 1-based class id.
CLASS_KEYPOINT_RANGES = {
    1: (0, 25), 2: (25, 58), 3: (58, 89), 4: (89, 128), 5: (128, 143),
    6: (143, 158), 7: (158, 168), 8: (168, 182), 9: (182, 190),
    10: (190, 219), 11: (219, 256), 12: (256, 275), 13: (275, 294),
}

# Per-class left/right keypoint symmetric pairs (1-based *within-class* indices).
_CLASS_FLIP_PAIRS = [
    [[2, 6], [3, 5], [7, 25], [8, 24], [9, 23], [10, 22], [11, 21],
     [12, 20], [13, 19], [14, 18], [15, 17]],
    [[2, 6], [3, 5], [7, 33], [8, 32], [9, 31], [10, 30], [11, 29],
     [12, 28], [13, 27], [14, 26], [15, 25], [16, 24], [17, 23],
     [18, 22], [19, 21]],
    [[2, 26], [3, 5], [4, 6], [7, 25], [8, 24], [9, 23], [10, 22],
     [11, 21], [12, 20], [13, 19], [14, 18], [15, 17], [16, 29],
     [27, 30], [28, 31]],
    [[2, 6], [3, 5], [4, 34], [7, 33], [8, 32], [9, 31], [10, 30],
     [11, 29], [12, 28], [13, 27], [14, 26], [15, 25], [16, 24],
     [17, 23], [18, 22], [19, 21], [20, 37], [35, 38], [36, 39]],
    [[2, 6], [3, 5], [7, 15], [8, 14], [9, 13], [10, 12]],
    [[2, 6], [3, 5], [7, 15], [8, 14], [9, 13], [10, 12]],
    [[1, 3], [4, 10], [5, 9], [6, 8]],
    [[1, 3], [4, 14], [5, 13], [6, 12], [7, 11], [8, 10]],
    [[1, 3], [4, 8], [5, 7]],
    [[2, 6], [3, 5], [7, 29], [8, 28], [9, 27], [10, 26], [11, 25],
     [12, 24], [13, 23], [14, 22], [15, 21], [16, 20], [17, 19]],
    [[2, 6], [3, 5], [7, 37], [8, 36], [9, 35], [10, 34], [11, 33],
     [12, 32], [13, 31], [14, 30], [15, 29], [16, 28], [17, 27],
     [18, 26], [19, 25], [20, 24], [21, 23]],
    [[2, 6], [3, 5], [7, 19], [8, 18], [9, 17], [10, 16], [11, 15],
     [12, 14]],
    [[2, 6], [3, 5], [7, 19], [8, 18], [9, 17], [10, 16], [11, 15],
     [12, 14]],
]


def flip_pairs(label):
    """0-based pairs of the 294-vector swapped by a flip of a garment of
    1-based class ``label``."""
    start = CLASS_KEYPOINT_RANGES[label][0]
    return [(a + start - 1, b + start - 1)
            for a, b in _CLASS_FLIP_PAIRS[label - 1]]
