"""Typed configuration for the SfM engine.

The reference hard-codes every policy constant in constructors
(/root/reference/CSfM.cpp:30-54, CTracker.cpp:25-45, CMap.cpp:25-29,
CScanGuidance.cpp:11-21) and camera calibration in main
(/root/reference/main/main.cpp:46-52).  Here the full constant table is one
frozen dataclass so a scan is reproducible from its config alone.

Static shape capacities (``max_keypoints`` etc.) have no analogue in the
reference (dynamic ``std::vector`` everywhere); they define the fixed tensor
shapes every jitted step compiles against.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SfMConfig:
    # ---- static capacities (compile-time shape constants) ----
    max_keypoints: int = 512       # per-frame detected feature budget
    max_keyframes: int = 64        # keyframe SoA capacity
    max_landmarks: int = 16384     # landmark SoA capacity
    desc_bits: int = 512           # binary descriptor width (BRISK is 512-bit)
    image_height: int = 480
    image_width: int = 640
    pyramid_levels: int = 4        # detector scale-space octaves

    # ---- detector (ref: BRISK thresh 60, 6 octaves — CTracker.cpp:43) ----
    fast_threshold: float = 20.0   # FAST-score intensity threshold (0..255 scale)
    feature_dtype: str = "float32"  # dense detector/descriptor compute dtype
                                    # ("bfloat16" halves the memory-bound
                                    # detection cost; geometry stays f32)
    patch_int8: bool = False       # int8 operands for the descriptor's
                                   # patch-extraction selection matmul;
                                   # quantization is 1/127 px of lerp +
                                   # ~0.5 intensity level, below the
                                   # sensor-noise floor
    nms_radius: int = 2            # non-max suppression radius (pixels)
    detector_approx_topk: bool = False  # lax.approx_max_k keypoint
                                        # selection (>=95% recall on the
                                        # weakest corners; exact top-k on
                                        # backends without an approximate
                                        # lowering)

    # ---- matcher (ref: CTracker.cpp:27-40) ----
    match_ratio: float = 0.8           # Lowe ratio test
    match_min_radius: float = 1.5      # motion window, px (ref _minMatchMotion)
    match_max_radius: float = 40.0     # motion window, px (ref _maxMatchMotion)
    match_max_distance: int = 90       # max Hamming distance (of desc_bits)
    min_features: int = 5              # minimum matches to proceed (ref _minFeatures)

    # ---- two-view init (ref: CSfM.cpp:842-859) ----
    h_inlier_threshold: float = 5.99   # homography score threshold, px^2-ish
    f_inlier_threshold: float = 3.84   # fundamental score threshold
    hf_model_ratio: float = 0.45       # pick H when s_h/(s_h+s_f) > 0.45
    ransac_hypotheses: int = 128       # fixed hypothesis batch (adaptive-count substitute)
    min_init_matches: int = 40         # matches needed to attempt bootstrap

    # ---- tracking / PnP (ref: CSfM.cpp:35, 39, 553-560) ----
    max_reproj_error: float = 7.0      # px, inlier + accuracy gate
    pnp_hypotheses: int = 32           # PnP RANSAC hypothesis batch (the
                                       # prior-pose hypothesis carries most
                                       # of the robustness in tracking)
    pnp_sample_size: int = 6           # 6-pt DLT pose minimal sample
    pnp_solver: str = "dlt"            # "dlt" (6-pt) or "p3p" (3-pt minimal
                                       # Grunert solver: 4 candidate poses
                                       # per sample; tolerates much lower
                                       # inlier ratios at equal batch size)
    pnp_refine_iters: int = 6          # pose-only Gauss-Newton iterations
    # motion-model fast path: skip the PnP hypothesis batch when the
    # refined prior pose already explains this fraction of the matches
    # (ORB-SLAM's track-with-motion-model).  Default off: the prior's 7 px
    # inlier gate admits matches full RANSAC would reject, measurably
    # degrading trajectory accuracy for ~1.5 ms/frame saved.
    pnp_fast_path_ratio: float = 0.0
    track_refine_iters: int = 4        # motion-only refinement over the
                                       # widened track set (0 disables)
    max_lost_frames: int = 10          # frames below min matches before LOST

    # ---- relocalization (real implementation of the reference's stub
    # recovery(), CSfM.cpp:774-778) ----
    # P3P, not DLT: reloc has no pose prior, and the global-match landmark
    # set is often quasi-planar (sprite/facade scenes), where 6-pt DLT is
    # degenerate — the nullspace becomes a homography family and NO
    # eigenvector is the pose (diagnosed on the round-2 75/128 bench
    # regression: DLT scored 0 inliers on 68%-correct match sets that P3P
    # solved).  Tracking keeps DLT by default because its prior-pose
    # hypothesis covers the degenerate cases.
    reloc_solver: str = "p3p"
    reloc_min_inliers: int = 10        # accept recovery at >= this support
                                       # (tracking re-polishes from there)

    # ---- flow-assisted tracking (the reference's disabled alternative
    # path: CTracker::computeOpticalFlow, CSfM.cpp:824).  When on, prev
    # frame map-linked features whose descriptor match failed are tracked
    # into the current frame with pyramidal LK and associated to the
    # nearest current detection — a recall boost for blur/low-texture
    # frames at the cost of running LK every frame. ----
    track_with_flow: bool = False
    flow_levels: int = 3               # LK pyramid levels (cv default 3)
    flow_iters: int = 10               # LK iterations per level
    flow_assoc_dist: float = 2.0       # flow-endpoint -> detection gate, px
                                       # (ref _maxOrgFeatDist=1, CTracker.cpp:33)

    # compact the candidate-landmark axis for the per-frame widen_tracks
    # matcher (findMapPointsInCurrentFrame) to the landmarks actually
    # projecting into the frame, over a dense axis of this static capacity
    # (0 = off, full landmark axis).  The [L, n_kp] Hamming matrix is the
    # per-frame matcher's dominant cost at large L while only a few
    # thousand landmarks are in view; overflow candidates skip widening
    # this frame (opportunistic, they retry next frame).
    track_widen_capacity: int = 0

    # ---- keyframe policy (ref: CSfM.cpp:44, 481-498) ----
    keyframe_time_lag: int = 10        # min frames between keyframes
    keyframe_min_tracked: int = 50     # min tracked points to insert
    keyframe_track_ratio: float = 0.9  # insert when tracks < 90% of last KF

    # ---- mapping (ref: CSfM.cpp:109-308) ----
    # The reference matches keyframe pairs with the same 40 px motion window
    # as frame-to-frame tracking (CSfM.cpp:146); with a multi-frame baseline
    # that starves triangulation, so the inter-keyframe window is a separate
    # (wider) knob here.
    mapping_max_radius: float = 120.0
    # windowed covisibility: mapping triangulates the new keyframe against
    # the most recent M keyframes and re-observes into the most recent R
    # (the reference's "all keyframes" degenerates at capacity; a recency
    # window bounds compute and approximates the covisibility graph the
    # reference commented out, CMap.h:94-95)
    mapping_tri_keyframes: int = 8
    mapping_reobs_keyframes: int = 16
    # window selection: covisibility (shared-landmark overlap with the new
    # keyframe, recency tiebreak — the graph the reference commented out,
    # CMap.h:94-95) vs pure recency.  Covisibility reconnects revisited
    # regions to the old map after loops.
    mapping_use_covisibility: bool = True
    # compact the landmark axis for the re-observation matcher to the
    # landmarks visible in >= 1 window keyframe (0 = off, full axis).
    # At 64k-slot maps the [L, n_kp] Hamming matrix dominates the mapping
    # pass while only a few thousand landmarks are in view; overflow
    # candidates skip re-observation this pass and retry next keyframe.
    mapping_reobs_capacity: int = 0

    # ---- culling (ref: CMap.cpp:27-28, 384-404; CSfM.cpp:708-752) ----
    cull_min_views: int = 3            # landmark seen by < 3 KFs -> cull
    cull_young_kf_age: int = 3         # "young" landmark age window (keyframes)
    cull_view_ratio: float = 0.25      # young: views/frames-alive below -> cull
    kf_cull_redundancy: float = 0.9    # cull KF if >=90% points seen by >3 others
    kf_cull_min_others: int = 3
    epipolar_max_error: float = 7.0    # triangulation epipolar filter, px

    # ---- bundle adjustment (replaces Ceres DENSE_SCHUR, CTracker.cpp:571-577) ----
    ba_iterations: int = 20            # outer LM iterations
    ba_lambda_init: float = 1e-3
    ba_lambda_up: float = 4.0
    ba_lambda_down: float = 2.0
    ba_huber_delta: float = 0.0        # 0 disables robust loss (ref uses NULL loss)
    ba_tol: float = 3e-4               # relative cost-decrease early-exit
    # mapping-BA solver for the reduced camera system: "dense" forms the
    # [6C, 6C] Schur complement exactly (run_ba; fastest up to ~64 KFs);
    # "cg" solves it with block-Jacobi PCG through per-observation tables
    # without the [C, L] coupling tensor (run_ba_cg; for large keyframe
    # capacities where the dense complement no longer fits); "large" builds
    # dual observation tables on device and runs the implicit-Schur PCG
    # solver (run_large_ba) — the 500+-keyframe operating point
    ba_solver: str = "dense"
    ba_kmax: int = 16                  # "large": observations kept per
                                       # landmark in the dual tables
    ba_cg_iterations: int = 15         # PCG iterations per LM step ("cg")
    # compact the landmark axis before the mapping-pass BA: only live
    # landmarks enter the normal equations, over a dense axis of this
    # static capacity (0 = off, use the full max_landmarks axis).  Every
    # landmark-side tensor — including the dense solver's [C, L, 6, 3]
    # coupling — shrinks by max_landmarks/capacity.  Live landmarks beyond
    # the capacity stay fixed for that pass (graceful overflow).
    ba_landmark_capacity: int = 0
    # local BA: free only the most recent N keyframe poses during the
    # mapping-pass BA (0 = all free, the reference's behavior — its "local"
    # BA optimizes every keyframe, CSfM.cpp:250-259).  Structure stays free
    # either way; fixed older poses anchor the gauge like ORB-SLAM's local
    # BA.
    ba_local_window: int = 0
    # periodic GLOBAL BA (all poses + structure free, implicit-Schur large
    # solver), run from the host (SfMEngine) every N keyframe insertions
    # (0 = off).  The windowed-local + periodic-global schedule is how the
    # engine reaches the 500-keyframe operating point the reference
    # handled by running all-keyframe BA inline (CSfM.cpp:250-259) —
    # unaffordable at 10x its map size.
    global_ba_every: int = 0
    global_ba_iterations: int = 10
    global_ba_cg_iterations: int = 25
    # observation slots per landmark for the GLOBAL BA tables (0 = use
    # ba_kmax).  Long scans re-observe landmarks from many keyframes; the
    # windowed-local BA can afford a small kmax, but dropping most of a
    # landmark's observations from global BA weakens the pose graph
    # (measured: 21k of ~48k observations dropped at kmax=8, 512-KF scan)
    global_ba_kmax: int = 0
    # robust-loss delta for GLOBAL BA (0 = use ba_huber_delta).  Global BA
    # linearizes at an accumulated-drift state where genuine inliers can
    # sit far beyond the local-BA delta; a tight Huber saturates their
    # gradients and the solver stalls (measured: 0 accepted LM steps at
    # cost 4.4e5 with delta=2 on the 512-KF longscan)
    global_ba_huber_delta: float = 0.0

    # ---- loop closure (net-new: the reference's covisibility graph is
    # commented out, CMap.h:94-95, and recovery() is a stub) ----
    # probe for loop closures every N keyframe insertions (0 = off): the
    # newest keyframe's unlinked detections are globally matched against
    # OLD landmarks and PnP'd; a confident pose disagreeing with odometry
    # by > loop_min_drift triggers the SE(3)-interpolated correction +
    # re-triangulation + global BA (engine/loop.py)
    loop_detect_every: int = 0
    loop_min_age: int = 30         # landmark age (KFs) to count as "old"
    loop_min_inliers: int = 25     # PnP support to accept a loop
    loop_min_drift: float = 0.05   # m of camera-center disagreement
    # apply the probe's monocular scale-drift estimate as a sim(3)
    # (rather than SE(3)) chain correction.  Round 5: the estimate is now
    # the robust median of PAIRWISE-DISTANCE ratios over old<->current
    # positions of the SAME matched physical points (invariant to the
    # SE(3) drift part), gated on pair count and dispersion — it degrades
    # to the identity (pure SE(3)) whenever the gate fails, so it is safe
    # on by default.  (The round-4 median-depth-ratio estimate compared
    # two different landmark populations, measured unreliable — 6.6 m vs
    # 0.83 m end drift — and shipped off; that negative result drove this
    # redesign.)
    loop_use_scale: bool = True
    loop_scale_min_pairs: int = 8      # matched old<->current point pairs
    loop_scale_max_dispersion: float = 0.15   # MAD/median gate

    # ---- scan guidance (ref: CScanGuidance.cpp:11-21) ----
    # guidance runs inside the jitted step on every RUNNING frame when the
    # engine is fed RGB frames (the reference's placement, CSfM.cpp:80-81);
    # grayscale input skips it (no H-S histogram without color)
    guidance_enabled: bool = True
    guidance_downscale: int = 4
    guidance_hist_bins_h: int = 60
    guidance_hist_bins_s: int = 50
    guidance_ema_alpha: float = 0.9
    guidance_backproj_threshold: float = 0.01

    # ---- parallel / distributed ----
    mesh_axis_map: str = "map"         # axis name for landmark sharding
    mesh_axis_data: str = "scan"       # axis name for batched multi-scan

    @property
    def desc_words(self) -> int:
        """Descriptor width in packed uint32 words."""
        return self.desc_bits // 32

    @property
    def image_size(self) -> Tuple[int, int]:
        return (self.image_height, self.image_width)


DEFAULT_CONFIG = SfMConfig()
