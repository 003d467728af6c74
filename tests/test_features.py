"""Feature stack tests: detector finds synthetic corners, descriptors match
across shifts/rotations, matcher honors the reference's contract
(window + ratio + dedup, CTracker.cpp:114-149)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from sfm_tpu.features import (
    detect, describe, build_pyramid, match_features, match_pairs,
    hamming_matrix, hamming_pairwise, pack_bits, unpack_bits,
)


def square_grid(h=480, w=640, sq=20, pitch=40):
    """Isolated bright squares on dark background — L-junction corners,
    which FAST-9 fires on (checkerboard X-junctions have only 8-long arcs
    and are correctly rejected by FAST)."""
    img = np.full((h, w), 20.0, np.float32)
    for y in range(40, h - 40 - sq, pitch):
        for x in range(40, w - 40 - sq, pitch):
            img[y:y + sq, x:x + sq] = 220.0
    return img


def random_texture(rng, h=480, w=640, n_blobs=150):
    img = np.full((h, w), 30.0, np.float32)
    for _ in range(n_blobs):
        y, x = rng.integers(30, h - 30), rng.integers(30, w - 30)
        s = rng.integers(4, 14)
        img[y:y + s, x:x + s] = rng.uniform(60, 250)
    return img


class TestBits:
    def test_pack_unpack_roundtrip(self, rng):
        bits = rng.integers(0, 2, (10, 512)).astype(np.float32)
        packed = pack_bits(jnp.asarray(bits))
        assert packed.shape == (10, 16) and packed.dtype == jnp.uint32
        back = unpack_bits(packed)
        np.testing.assert_array_equal(np.asarray(back), bits)

    def test_hamming_matrix_exact(self, rng):
        a = rng.integers(0, 2, (16, 512)).astype(np.float32)
        b = rng.integers(0, 2, (24, 512)).astype(np.float32)
        D = hamming_matrix(pack_bits(jnp.asarray(a)), pack_bits(jnp.asarray(b)))
        ref = (a[:, None, :] != b[None, :, :]).sum(-1)
        np.testing.assert_array_equal(np.asarray(D), ref)

    def test_hamming_pairwise_matches_matrix(self, rng):
        a = pack_bits(jnp.asarray(rng.integers(0, 2, (8, 512)).astype(np.float32)))
        b = pack_bits(jnp.asarray(rng.integers(0, 2, (8, 512)).astype(np.float32)))
        d = hamming_pairwise(a, b)
        D = hamming_matrix(a, b)
        np.testing.assert_array_equal(np.asarray(d),
                                      np.asarray(jnp.diagonal(D)))


class TestDetector:
    def test_finds_square_corners(self):
        img = jnp.asarray(square_grid())
        kps = detect(img, max_keypoints=256, levels=3, threshold=20.0)
        n = int(jnp.sum(kps.valid))
        assert n > 50
        # detected level-0 corners should lie near square corners: squares
        # span [40+k*40, 40+k*40+20) so corners sit at multiples of 20
        m = np.asarray(kps.valid) & (np.asarray(kps.level) == 0)
        xy = np.asarray(kps.xy)[m]
        offs = xy % 20
        near = np.minimum(offs, 20 - offs)
        assert np.median(near.max(axis=1)) < 4.0

    def test_scores_sorted_and_valid_mask(self, rng):
        img = jnp.asarray(random_texture(rng))
        kps = detect(img, max_keypoints=512, levels=4)
        s = np.asarray(kps.score)
        assert (np.diff(s) <= 1e-5).all()
        assert bool(jnp.all(kps.score[~np.asarray(kps.valid)] <= 0))

    def test_blank_image_no_keypoints(self):
        img = jnp.full((480, 640), 100.0)
        kps = detect(img, max_keypoints=128, levels=2)
        assert int(jnp.sum(kps.valid)) == 0

    def test_approx_topk_matches_exact_selection(self, rng):
        # approx_topk may lower to an approximate top-k; selection must
        # heavily overlap the exact sort (misses only among weak corners)
        img = jnp.asarray(random_texture(rng))
        exact = detect(img, max_keypoints=256, levels=3)
        approx = detect(img, max_keypoints=256, levels=3, approx_topk=True)
        ex = {tuple(p) for p in
              np.asarray(exact.xy)[np.asarray(exact.valid)].round(2).tolist()}
        ap = {tuple(p) for p in
              np.asarray(approx.xy)[np.asarray(approx.valid)].round(2).tolist()}
        n = max(len(ex), 1)
        assert len(ex & ap) / n > 0.9
        s = np.asarray(approx.score)[np.asarray(approx.valid)]
        assert (s > 0).all()


class TestDescriptor:
    def test_descriptor_stable_under_shift(self, rng):
        img = random_texture(rng)
        shift = 7
        img2 = np.roll(img, (shift, shift), axis=(0, 1))
        kps1 = detect(jnp.asarray(img), max_keypoints=128, levels=3)
        kps2 = detect(jnp.asarray(img2), max_keypoints=128, levels=3)
        d1 = describe(build_pyramid(jnp.asarray(img), 3), kps1)
        d2 = describe(build_pyramid(jnp.asarray(img2), 3), kps2)
        res = match_features(
            d1, kps1.xy, kps1.valid, d2, kps2.xy, kps2.valid,
            min_radius=0.0, max_radius=30.0, max_distance=120.0)
        n = int(jnp.sum(res.mask))
        assert n > 30
        # matched displacement must equal the shift
        disp = np.asarray(kps2.xy)[np.asarray(res.idx)] - np.asarray(kps1.xy)
        disp = disp[np.asarray(res.mask)]
        med = np.median(disp, axis=0)
        np.testing.assert_allclose(med, [shift, shift], atol=1.0)


class TestPatchInt8:
    def test_int8_patch_bits_near_parity(self, rng):
        """The int8 patch-extraction path must flip only a small fraction
        of descriptor bits vs the float path (quantization ~0.5 intensity
        level, far below the matcher's distance threshold)."""
        from sfm_tpu.features.detect import detect, build_canvas
        from sfm_tpu.features.descriptor import describe_canvas
        from sfm_tpu.features.bits import unpack_bits
        img = random_texture(rng)
        kps, canvas = detect(jnp.asarray(img), max_keypoints=128, levels=3,
                             return_canvas=True)
        d_f = describe_canvas(canvas, kps, 3, img.shape[1])
        d_q = describe_canvas(canvas, kps, 3, img.shape[1],
                              patch_int8=True)
        b_f = np.asarray(unpack_bits(d_f))[np.asarray(kps.valid)]
        b_q = np.asarray(unpack_bits(d_q))[np.asarray(kps.valid)]
        flip = float((b_f != b_q).mean())
        # a few % of bits sit on quantization-sensitive near-zero pair
        # differences; the Hamming matcher tolerates ~90/512
        assert flip < 0.06, flip


class TestMatcher:
    def _mk(self, rng, n, bits=512):
        d = rng.integers(0, 2, (n, bits)).astype(np.float32)
        return d

    def test_identical_descriptors_match(self, rng):
        d = self._mk(rng, 32)
        packed = pack_bits(jnp.asarray(d))
        xy = jnp.asarray(rng.uniform(0, 100, (32, 2)).astype(np.float32))
        v = jnp.ones(32, bool)
        res = match_features(packed, xy, v, packed, xy, v,
                             min_radius=0.0, max_radius=10.0,
                             max_distance=90.0)
        np.testing.assert_array_equal(np.asarray(res.idx), np.arange(32))
        assert bool(jnp.all(res.mask))

    def test_window_excludes_far_targets(self, rng):
        d = self._mk(rng, 4)
        packed = pack_bits(jnp.asarray(d))
        xy0 = jnp.zeros((4, 2))
        xy1 = jnp.asarray([[5.0, 0.0], [100.0, 0.0], [3.0, 0.0], [0.5, 0.0]])
        v = jnp.ones(4, bool)
        res = match_features(packed, xy0, v, packed, xy1, v,
                             min_radius=1.5, max_radius=40.0,
                             max_distance=90.0)
        m = np.asarray(res.mask)
        assert m[0] and m[2]
        assert not m[1]  # beyond max radius
        assert not m[3]  # inside min radius

    def test_ratio_test_rejects_ambiguous(self, rng):
        base = rng.integers(0, 2, 512).astype(np.float32)
        d0 = base.copy()
        # two targets nearly equidistant from d0 -> ambiguous -> reject
        t1 = base.copy(); t1[:40] = 1 - t1[:40]
        t2 = base.copy(); t2[40:82] = 1 - t2[40:82]
        packed0 = pack_bits(jnp.asarray(d0[None]))
        packed1 = pack_bits(jnp.asarray(np.stack([t1, t2])))
        xy0 = jnp.zeros((1, 2))
        xy1 = jnp.zeros((2, 2)) + 5.0
        res = match_features(packed0, xy0, jnp.ones(1, bool),
                             packed1, xy1, jnp.ones(2, bool),
                             min_radius=0.0, max_radius=40.0,
                             max_distance=90.0, ratio=0.8)
        assert not bool(res.mask[0])

    def test_dedup_best_source_wins_target(self, rng):
        tgt = rng.integers(0, 2, 512).astype(np.float32)
        near = tgt.copy(); near[:10] = 1 - near[:10]     # dist 10
        far = tgt.copy(); far[:30] = 1 - far[:30]        # dist 30
        d0 = pack_bits(jnp.asarray(np.stack([far, near])))
        d1 = pack_bits(jnp.asarray(tgt[None]))
        xy0 = jnp.zeros((2, 2))
        xy1 = jnp.zeros((1, 2)) + 3.0
        res = match_features(d0, xy0, jnp.ones(2, bool),
                             d1, xy1, jnp.ones(1, bool),
                             min_radius=0.0, max_radius=40.0,
                             max_distance=90.0)
        m = np.asarray(res.mask)
        assert m[1] and not m[0]  # the closer source keeps the target

    def test_match_pairs_compaction(self, rng):
        d = self._mk(rng, 16)
        packed = pack_bits(jnp.asarray(d))
        xy = jnp.asarray(rng.uniform(0, 50, (16, 2)).astype(np.float32))
        v = jnp.asarray(np.arange(16) % 2 == 0)
        res = match_features(packed, xy, v, packed, xy, v,
                             min_radius=0.0, max_radius=5.0,
                             max_distance=90.0)
        idx0, idx1, valid = match_pairs(res, cap=8)
        n = int(jnp.sum(res.mask))
        assert int(jnp.sum(valid)) == min(n, 8)
        # compacted pairs agree with the raw result
        for a, b, ok in zip(np.asarray(idx0), np.asarray(idx1),
                            np.asarray(valid)):
            if ok:
                assert np.asarray(res.idx)[a] == b


class TestRotationInvariance:
    def test_descriptor_survives_90_degree_rotation(self, rng):
        """The steered descriptor must match across a global image
        rotation (the BRISK rotation-invariance property)."""
        img = random_texture(rng, h=320, w=320)
        img2 = np.rot90(img).copy()
        kps1 = detect(jnp.asarray(img), max_keypoints=128, levels=3)
        kps2 = detect(jnp.asarray(img2), max_keypoints=128, levels=3)
        d1 = describe(build_pyramid(jnp.asarray(img), 3), kps1)
        d2 = describe(build_pyramid(jnp.asarray(img2), 3), kps2)
        # rotate kps1 coords into the rotated frame: (x, y) -> (y, W-1-x)
        w = img.shape[1]
        xy1_rot = np.stack([np.asarray(kps1.xy)[:, 1],
                            w - 1 - np.asarray(kps1.xy)[:, 0]], -1)
        res = match_features(
            d1, jnp.asarray(xy1_rot.astype(np.float32)), kps1.valid,
            d2, kps2.xy, kps2.valid,
            min_radius=0.0, max_radius=3.0, max_distance=150.0, ratio=0.95)
        # matched pairs must be spatially consistent (within the window by
        # construction); require a healthy yield
        n = int(jnp.sum(res.mask))
        assert n > 30



class TestMatchReference:
    """match_features against the independent NumPy brute-force matcher
    (sfm_tpu/features/reference.py): integer Hamming distances make the
    comparison exact."""

    CASES = {
        "window": dict(min_radius=1.5, max_radius=40.0, max_distance=90.0,
                       ratio=0.8),
        "window_centers": dict(min_radius=0.0, max_radius=7.0,
                               max_distance=90.0, ratio=0.8,
                               centers=True),
        "strict_ratio": dict(min_radius=0.0, max_radius=1e9,
                             max_distance=200.0, ratio=0.6),
        "loose_ratio_ties": dict(min_radius=0.0, max_radius=60.0,
                                 max_distance=256.0, ratio=0.99, dups=4),
    }

    @pytest.mark.parametrize("case", sorted(CASES))
    def test_exact_vs_brute_force(self, case):
        from sfm_tpu.features.reference import brute_force_match, random_case
        kw = dict(self.CASES[case])
        centers, dups = kw.pop("centers", False), kw.pop("dups", 0)
        rng = np.random.default_rng(len(case))
        d0, xy0, v0, d1, xy1, v1 = random_case(rng, 300, 96)
        if dups:
            # many sources identical to one another: the per-target
            # winner is decided by the lowest source index alone
            d0[1:1 + dups] = d0[0]
            xy0[1:1 + dups] = xy0[0]
            v0[:1 + dups] = True
        if centers:
            kw["window_center0"] = (xy0 + rng.normal(0, 2, xy0.shape)
                                    ).astype(np.float32)
        got = jax.device_get(match_features(d0, xy0, v0, d1, xy1, v1, **kw))
        idx, dist, mask = brute_force_match(d0, xy0, v0, d1, xy1, v1, **kw)
        assert mask.sum() > 10
        np.testing.assert_array_equal(got.mask, mask)
        np.testing.assert_array_equal(got.idx, idx)
        np.testing.assert_array_equal(got.dist, dist)

    def test_brute_force_dedup_keeps_lowest_source(self):
        """The reference itself: equal sources tie on distance and the
        lowest source index keeps the target."""
        from sfm_tpu.features.reference import brute_force_match
        rng = np.random.default_rng(0)
        d1 = rng.integers(0, 2**32, (4, 16), dtype=np.uint64).astype(
            np.uint32)
        d0 = np.repeat(d1[2:3], 3, axis=0)
        xy = np.zeros((3, 2), np.float32)
        idx, dist, mask = brute_force_match(
            d0, xy, np.ones(3, bool), d1, np.zeros((4, 2), np.float32),
            np.ones(4, bool), max_distance=90.0, ratio=0.8)
        np.testing.assert_array_equal(idx, [2, -1, -1])
        np.testing.assert_array_equal(mask, [True, False, False])
        assert dist[0] == 0.0
