"""Feature stack: scale-space FAST detection, oriented binary descriptors,
and Hamming matching as popcount-matmul — the accelerator replacement for the
reference's brisk detector/extractor/matcher surface (SURVEY.md §2.11) and
CTracker's matcher family (§2.2)."""

from .detect import Keypoints, detect, build_pyramid, fast_score, nms, \
    shi_tomasi_score
from .descriptor import describe, orientation, smooth, bilinear
from .bits import unpack_bits, pack_bits, hamming_matrix, hamming_pairwise
from .match import MatchResult, match_features, match_pairs
