"""World state: per-frame feature records, keyframe SoA, landmark SoA.

Fixed-shape redesign of CFrame/CKeyFrame/CMap (SURVEY.md §2.3-2.5):

- ``Frame`` replaces CFrame: fixed-capacity keypoint arrays + pose + the
  2D->3D link vector (CFrame::_pts3DIdx, -1 = unlinked).  Frames are value
  types (pytrees), so "keyframe creation snapshots the frame" (CKeyFrame's
  copy-construction, CKeyFrame.cpp:34) is just storing the pytree.
- ``KeyframeStore`` replaces the keyframe vector + CKeyFrame: a stacked
  Frame with a validity mask.  Slots are reused after culling.
- ``LandmarkStore`` replaces CMap: landmark ids are slot indices; culling
  tombstones the slot (CMap.cpp:406-474's tombstone trick) and the engine
  simultaneously clears every keyframe link to it, so slot reuse is safe.

There are NO observation multimaps: the keyframes' ``landmark`` link arrays
are the single source of truth.  CMap's point->frames / frame->points
multimaps (CMap.h:83-97) become masked reductions over the [K, N] link
matrix — O(K*N) data-parallel scans instead of hash maps, which is the
right trade on a vector machine and removes the mutual-consistency
invariants by construction.

Representative descriptors use per-bit saturating vote counters (int8,
+1 per set bit, -1 per clear bit, clipped to +-127; majority = sign) —
the bit-majority replacement for the O(obs^2) Hamming medoid that the
reference's own TODO suggests (CMap.cpp:344), in 1/4 the memory of plain
counts and adaptive to recent observations once saturated.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from .features.bits import unpack_bits, pack_bits


class Frame(NamedTuple):
    """Per-frame record (CFrame equivalent).  Capacity N keypoints."""
    xy: jnp.ndarray        # [N, 2] f32 undistorted pixels (Kopt model)
    xy_dist: jnp.ndarray   # [N, 2] f32 raw (distorted) detector coords
    desc: jnp.ndarray      # [N, W] uint32 packed descriptors
    color: jnp.ndarray     # [N, 3] f32 sampled image color at the keypoint
    level: jnp.ndarray     # [N] int32 pyramid level
    score: jnp.ndarray     # [N] f32 detector response
    kp_valid: jnp.ndarray  # [N] bool: keypoint detected
    landmark: jnp.ndarray  # [N] int32 landmark slot or -1 (CFrame _pts3DIdx)
    rvec: jnp.ndarray      # [3] world-to-camera rotation (Rodrigues)
    tvec: jnp.ndarray      # [3]
    frame_no: jnp.ndarray  # scalar int32

    @property
    def matched(self) -> jnp.ndarray:
        """CFrame::_status equivalent: keypoint is linked to a landmark."""
        return self.landmark >= 0

    @property
    def n_matched(self) -> jnp.ndarray:
        return jnp.sum(self.matched & self.kp_valid)


def empty_frame(n_kp: int, desc_words: int) -> Frame:
    return Frame(
        xy=jnp.zeros((n_kp, 2), jnp.float32),
        xy_dist=jnp.zeros((n_kp, 2), jnp.float32),
        desc=jnp.zeros((n_kp, desc_words), jnp.uint32),
        color=jnp.zeros((n_kp, 3), jnp.float32),
        level=jnp.zeros((n_kp,), jnp.int32),
        score=jnp.zeros((n_kp,), jnp.float32),
        kp_valid=jnp.zeros((n_kp,), bool),
        landmark=jnp.full((n_kp,), -1, jnp.int32),
        rvec=jnp.zeros((3,), jnp.float32),
        tvec=jnp.zeros((3,), jnp.float32),
        frame_no=jnp.asarray(-1, jnp.int32),
    )


class KeyframeStore(NamedTuple):
    """Stacked Frame pytree + slot validity.  Capacity K keyframes."""
    frames: Frame          # every leaf has leading axis K
    valid: jnp.ndarray     # [K] bool


def empty_keyframes(k: int, n_kp: int, desc_words: int) -> KeyframeStore:
    proto = empty_frame(n_kp, desc_words)
    frames = jax.tree.map(lambda x: jnp.broadcast_to(x, (k,) + x.shape).copy(),
                          proto)
    return KeyframeStore(frames=frames, valid=jnp.zeros((k,), bool))


class LandmarkStore(NamedTuple):
    """Landmark SoA (CMap equivalent).  Capacity L, slot index = id."""
    xyz: jnp.ndarray          # [L, 3] f32
    desc_votes: jnp.ndarray   # [L, B] int8 saturating bit-majority votes
    color_sum: jnp.ndarray    # [L, 3] f32 running observed-color sum
    n_desc: jnp.ndarray       # [L] int32 descriptors accumulated
    n_views: jnp.ndarray      # [L] int32 tracked-frame views (CMap _ptsViews)
    kf_alive: jnp.ndarray     # [L] int32 age in keyframes (CMap _kfAlive)
    t_alive: jnp.ndarray      # [L] int32 age in frames (CMap _timeAlive)
    valid: jnp.ndarray        # [L] bool


def empty_landmarks(l: int, desc_bits: int) -> LandmarkStore:
    return LandmarkStore(
        xyz=jnp.zeros((l, 3), jnp.float32),
        desc_votes=jnp.zeros((l, desc_bits), jnp.int8),
        color_sum=jnp.zeros((l, 3), jnp.float32),
        n_desc=jnp.zeros((l,), jnp.int32),
        n_views=jnp.zeros((l,), jnp.int32),
        kf_alive=jnp.zeros((l,), jnp.int32),
        t_alive=jnp.zeros((l,), jnp.int32),
        valid=jnp.zeros((l,), bool),
    )


# ---------------------------------------------------------------------------
# landmark ops
# ---------------------------------------------------------------------------

def allocate_slots(free: jnp.ndarray, want: jnp.ndarray) -> jnp.ndarray:
    """Masked slot allocator: for each requested entry (want[j]), the index
    of a distinct free slot, or -1 on overflow.  free, want: bool arrays."""
    order = jnp.argsort(~free, stable=True)       # free slots first, by index
    n_free = jnp.sum(free)
    rank = jnp.cumsum(want.astype(jnp.int32)) - 1
    slot = order[jnp.clip(rank, 0, free.shape[0] - 1)]
    ok = want & (rank < n_free)
    return jnp.where(ok, slot, -1).astype(jnp.int32)


def add_landmarks(lms: LandmarkStore, xyz: jnp.ndarray, desc: jnp.ndarray,
                  want: jnp.ndarray, n_initial_views: jnp.ndarray,
                  colors: jnp.ndarray = None
                  ) -> Tuple[LandmarkStore, jnp.ndarray]:
    """Bulk append (CMap::addNewPoints, CMap.cpp:36-78).

    xyz [M,3], desc [M,W] packed, want [M] bool, n_initial_views [M] int
    (the number of observing frames — the reference initializes _ptsViews to
    it, CMap.cpp:57).  Returns (store, ids [M] with -1 for dropped)."""
    ids = allocate_slots(~lms.valid, want)
    ok = ids >= 0
    # drop-mode scatters with an out-of-range sentinel: a shared in-range
    # placeholder (".at[where(ok, ids, 0)].set(...)") makes every dropped
    # entry race the genuine slot-0 write — duplicate-index scatter-set
    # order is undefined, so slot 0's contents (including validity!)
    # became backend-dependent
    L = lms.valid.shape[0]
    idx = jnp.where(ok, ids, L)
    votes = (2 * unpack_bits(desc) - 1.0).astype(jnp.int8)
    if colors is None:
        colors = jnp.zeros(xyz.shape[:1] + (3,), jnp.float32)
    new = LandmarkStore(
        xyz=lms.xyz.at[idx].set(xyz, mode="drop"),
        desc_votes=lms.desc_votes.at[idx].set(votes, mode="drop"),
        color_sum=lms.color_sum.at[idx].set(colors, mode="drop"),
        n_desc=lms.n_desc.at[idx].set(1, mode="drop"),
        n_views=lms.n_views.at[idx].set(n_initial_views, mode="drop"),
        kf_alive=lms.kf_alive.at[idx].set(0, mode="drop"),
        t_alive=lms.t_alive.at[idx].set(0, mode="drop"),
        valid=lms.valid.at[idx].set(True, mode="drop"),
    )
    return new, ids


def add_descriptors(lms: LandmarkStore, ids: jnp.ndarray, desc: jnp.ndarray,
                    colors: jnp.ndarray = None) -> LandmarkStore:
    """Stack one observed descriptor (and color sample) per landmark
    (CMap::addDescriptors, CMap.cpp:308-315) — here a running bit-count
    accumulation; colors feed the reconstruction's color output (the gap at
    CSfM.cpp:798-800)."""
    ok = ids >= 0
    safe = jnp.where(ok, ids, 0)
    votes = (2 * unpack_bits(desc) - 1.0).astype(jnp.int8) * \
        ok[:, None].astype(jnp.int8)
    # saturating accumulate in int16, clip back to the int8 range
    acc = jnp.clip(lms.desc_votes.astype(jnp.int16).at[safe].add(
        votes.astype(jnp.int16)), -127, 127).astype(jnp.int8)
    out = lms._replace(
        desc_votes=acc,
        n_desc=lms.n_desc.at[safe].add(ok.astype(jnp.int32)),
    )
    if colors is not None:
        out = out._replace(color_sum=out.color_sum.at[safe].add(
            colors * ok[:, None]))
    return out


def landmark_colors(lms: LandmarkStore) -> jnp.ndarray:
    """[L, 3] mean observed color per landmark."""
    return lms.color_sum / jnp.maximum(lms.n_desc[:, None], 1).astype(
        jnp.float32)


def add_views(lms: LandmarkStore, ids: jnp.ndarray) -> LandmarkStore:
    """CMap::updatePointViews (CMap.cpp:569-574): bump tracked-view count."""
    ok = ids >= 0
    safe = jnp.where(ok, ids, 0)
    return lms._replace(n_views=lms.n_views.at[safe].add(ok.astype(jnp.int32)))


def representative_descriptors(lms: LandmarkStore) -> jnp.ndarray:
    """Per-landmark majority-vote descriptor [L, W] uint32 — replaces the
    O(obs^2) Hamming medoid (CMap::getRepresentativeDescriptors,
    CMap.cpp:343-381; the TODO at :344 suggests exactly this).  Majority =
    positive saturating vote counter."""
    return pack_bits(lms.desc_votes > 0)


def increment_age(lms: LandmarkStore, t_inc: int, kf_inc: int) -> LandmarkStore:
    """CMap::incrementMapAge (CMap.cpp:561-567): age live landmarks."""
    live = lms.valid.astype(jnp.int32)
    return lms._replace(
        t_alive=lms.t_alive + t_inc * live,
        kf_alive=lms.kf_alive + kf_inc * live,
    )


def kf_view_counts(kfs: KeyframeStore, n_landmarks: int) -> jnp.ndarray:
    """[L] number of valid keyframes observing each landmark — the on-the-fly
    replacement for CMap's point->frames multimap."""
    links = kfs.frames.landmark                       # [K, N]
    obs = (links >= 0) & kfs.frames.kp_valid & kfs.valid[:, None]
    flat = jnp.where(obs, links, n_landmarks).reshape(-1)
    counts = jnp.zeros((n_landmarks + 1,), jnp.int32).at[flat].add(1)
    return counts[:n_landmarks]


def cull_landmarks(lms: LandmarkStore, kf_views: jnp.ndarray,
                   *, min_views: int = 3, young_age: int = 3,
                   view_ratio: float = 0.25
                   ) -> Tuple[LandmarkStore, jnp.ndarray]:
    """CMap::removePointsThreshold policy (CMap.cpp:384-404):

    young (1 <= kf_alive <= young_age): cull if tracked-view ratio
      n_views / t_alive < view_ratio OR seen by < min_views keyframes;
    old (kf_alive > young_age): cull if seen by < min_views keyframes.

    Returns (store, tombstone mask [L] of culled slots).  The caller must
    clear keyframe links to the tombstones (CSfM.cpp:692-706's fan-out)."""
    ratio = lms.n_views.astype(jnp.float32) / jnp.maximum(
        lms.t_alive.astype(jnp.float32), 1.0)
    young = (lms.kf_alive >= 1) & (lms.kf_alive <= young_age)
    old = lms.kf_alive > young_age
    few_kf = kf_views < min_views
    cull = (young & ((ratio < view_ratio) | few_kf)) | (old & few_kf)
    cull = cull & lms.valid
    return lms._replace(valid=lms.valid & ~cull), cull


def clear_links(frame_landmark: jnp.ndarray, tomb: jnp.ndarray) -> jnp.ndarray:
    """Unlink culled landmarks from a frame's link vector
    (CFrame::cullPoints, CFrame.cpp:461-471)."""
    linked = frame_landmark >= 0
    safe = jnp.where(linked, frame_landmark, 0)
    dead = tomb[safe] & linked
    return jnp.where(dead, -1, frame_landmark)


# ---------------------------------------------------------------------------
# keyframe ops
# ---------------------------------------------------------------------------

def insert_keyframe(kfs: KeyframeStore, frame: Frame
                    ) -> Tuple[KeyframeStore, jnp.ndarray]:
    """Snapshot a frame into the first free slot.  Returns (store, slot)
    with slot == -1 on overflow (caller may cull first)."""
    slot = allocate_slots(~kfs.valid, jnp.asarray([True]))[0]
    ok = slot >= 0
    safe = jnp.where(ok, slot, 0)

    def put(stored, new):
        updated = stored.at[safe].set(new)
        return jnp.where(ok, updated, stored)

    frames = jax.tree.map(put, kfs.frames, frame)
    valid = kfs.valid.at[safe].set(ok | kfs.valid[safe])
    return KeyframeStore(frames=frames, valid=valid), slot


def remove_keyframe(kfs: KeyframeStore, slot: jnp.ndarray) -> KeyframeStore:
    """Drop one keyframe (CMap::removeFrame + CSfM's reindexing,
    CMap.cpp:483-541, CSfM.cpp:741-749).  Because observations are derived
    from the link matrix, invalidating the slot removes its observations
    everywhere at once; no descriptor-stack rebuild is needed (bit-counts
    keep the removed frame's contribution, a deliberate approximation)."""
    ok = slot >= 0
    safe = jnp.where(ok, slot, 0)
    return kfs._replace(valid=kfs.valid.at[safe].set(
        jnp.where(ok, False, kfs.valid[safe])))


def cull_keyframes(kfs: KeyframeStore, n_landmarks: int,
                   *, redundancy: float = 0.9, min_others: int = 3,
                   keep_first: int = 2) -> Tuple[KeyframeStore, jnp.ndarray]:
    """CSfM::cullKeyFrames (CSfM.cpp:708-752): greedily remove any keyframe
    >= ``redundancy`` of whose tracked points are seen by > ``min_others``
    other keyframes.  The reference loops oldest-first and re-evaluates
    after each removal; we mirror that with a fixed-trip lax.scan over
    slots.  The first ``keep_first`` inserted keyframes (bootstrap pair)
    are exempt, as in the reference (loop starts at index 1, and removing
    the origin frame would drop the gauge)."""
    K = kfs.valid.shape[0]
    order = jnp.argsort(jnp.where(kfs.valid, kfs.frames.frame_no,
                                  jnp.int32(2**30)))
    # greedy re-evaluation without per-step recounting: start from the full
    # view counts and subtract a culled keyframe's links as we go (a 512-
    # element scatter instead of recounting all 16k links per candidate)
    counts0 = _kf_view_counts_masked(kfs, kfs.valid, n_landmarks)

    def body(carry, i):
        valid, counts = carry
        k = order[i]
        links = kfs.frames.landmark[k]
        obs = (links >= 0) & kfs.frames.kp_valid[k]
        safe = jnp.where(obs, links, 0)
        seen_others = counts[safe] - 1         # exclude this keyframe itself
        redundant = obs & (seen_others > min_others)
        n_obs = jnp.sum(obs)
        frac = jnp.sum(redundant) / jnp.maximum(n_obs, 1)
        is_young_rank = i < keep_first
        cull = valid[k] & (frac >= redundancy) & (n_obs > 0) & ~is_young_rank
        counts = counts.at[jnp.where(obs & cull, links, n_landmarks)].add(
            -1, mode="drop")
        return (valid.at[k].set(valid[k] & ~cull), counts), cull

    (valid, _), culled = jax.lax.scan(body, (kfs.valid, counts0),
                                      jnp.arange(K))
    return kfs._replace(valid=valid), culled


def _kf_view_counts_masked(kfs: KeyframeStore, valid: jnp.ndarray,
                           n_landmarks: int) -> jnp.ndarray:
    links = kfs.frames.landmark
    obs = (links >= 0) & kfs.frames.kp_valid & valid[:, None]
    flat = jnp.where(obs, links, n_landmarks).reshape(-1)
    counts = jnp.zeros((n_landmarks + 1,), jnp.int32).at[flat].add(1)
    return counts[:n_landmarks]
