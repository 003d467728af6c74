"""Asynchronous frontend/backend pipeline (SURVEY.md §2.14 item 3).

ORB-SLAM runs tracking (latency-critical) and mapping+BA (throughput) on
separate threads; the reference collapsed both into one synchronous
``addFrame`` (CSfM.cpp:77-79).  Here the split is revived across devices:
tracking steps run on one device while the mapping pass for the latest
keyframe runs as an independently dispatched XLA computation on another
device, and the two state timelines are reconciled by a pure merge.

Why a merge is exact here: tracking never allocates or frees store slots
— between the snapshot S0 (mapping input) and the current tracked state
Sk it only (a) advances the reference frame, (b) adds links/view counts/
descriptor votes for existing landmarks, (c) inserts whole keyframes.
The mapping output M reorganizes the stores (new landmarks, culls, BA).
Within ONE mapping pass, slot insertion (triangulation) happens before
landmark culling, so a slot valid in both S0 and M is the SAME landmark;
all of tracking's per-landmark updates are additive counters, so they
replay onto M as deltas.  Keyframes inserted during the flight are copied
into M's store (mapping only culls keyframes, never inserts, so their
slots are still free) with stale landmark links cleared.

The tracked pose needs no correction at merge: PnP refits the pose
against the (updated) map on the very next frame; the only transient is
one frame's matching-window center.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..config import SfMConfig
from ..engine.state import SfMState, CameraParams, init_state
from ..engine.step import build_step
from ..engine.mapping import mapping_pass
from ..mapstore import representative_descriptors


def _delta(m, sk, s0, same):
    """Replay tracking's additive update (sk - s0) on top of M, on slots
    that stayed the same landmark."""
    mask = same.reshape(same.shape + (1,) * (m.ndim - 1))
    if m.dtype == jnp.int8:  # saturating descriptor votes
        wide = (m.astype(jnp.int16)
                + jnp.where(mask, sk.astype(jnp.int16) - s0.astype(jnp.int16),
                            0))
        return jnp.clip(wide, -127, 127).astype(jnp.int8)
    return m + jnp.where(mask, sk - s0, jnp.zeros_like(m))


def merge_mapping_result(sk: SfMState, s0: SfMState, m: SfMState
                         ) -> SfMState:
    """Reconcile the tracked timeline Sk with the mapping output M
    (computed from snapshot S0).  Pure; jit it once."""
    same = s0.lms.valid & m.lms.valid          # stable landmark slots

    lms = m.lms._replace(
        desc_votes=_delta(m.lms.desc_votes, sk.lms.desc_votes,
                          s0.lms.desc_votes, same),
        color_sum=_delta(m.lms.color_sum, sk.lms.color_sum,
                         s0.lms.color_sum, same),
        n_desc=_delta(m.lms.n_desc, sk.lms.n_desc, s0.lms.n_desc, same),
        n_views=_delta(m.lms.n_views, sk.lms.n_views, s0.lms.n_views, same),
        kf_alive=_delta(m.lms.kf_alive, sk.lms.kf_alive, s0.lms.kf_alive,
                        same),
        t_alive=_delta(m.lms.t_alive, sk.lms.t_alive, s0.lms.t_alive, same),
    )

    def keep_link(landmark):
        safe = jnp.where(landmark >= 0, landmark, 0)
        return jnp.where((landmark >= 0) & same[safe], landmark, -1)

    # keyframes inserted during the flight: copy Sk's rows into M's store
    # (mapping only culls, so those slots are free in M), stale links
    # cleared against M's culls
    new_kf = sk.kfs.valid & ~s0.kfs.valid
    frames = jax.tree.map(
        lambda mf, sf: jnp.where(
            new_kf.reshape((-1,) + (1,) * (mf.ndim - 1)), sf, mf),
        m.kfs.frames, sk.kfs.frames)
    cleared = jax.vmap(keep_link)(frames.landmark)
    frames = frames._replace(
        landmark=jnp.where(new_kf[:, None], cleared, frames.landmark))
    kfs = m.kfs._replace(frames=frames, valid=m.kfs.valid | new_kf)

    prev = sk.prev._replace(landmark=keep_link(sk.prev.landmark))

    return sk._replace(
        lms=lms, kfs=kfs, prev=prev,
        rep_desc=representative_descriptors(lms),
    )


class AsyncMappingEngine:
    """Host driver for the pipelined engine: tracking on ``track_device``,
    mapping dispatched to ``map_device``, merged after ``merge_lag``
    tracked frames (or immediately when another keyframe is pending).

    With one device this degrades gracefully to deferred-but-serial
    mapping; with two, the mapping pass overlaps tracking the way
    ORB-SLAM's LocalMapping thread overlaps its Tracking thread."""

    def __init__(self, cfg: SfMConfig, cam: CameraParams,
                 track_device=None, map_device=None, merge_lag: int = 2):
        devs = jax.devices()
        self.d_track = track_device if track_device is not None else devs[0]
        self.d_map = (map_device if map_device is not None
                      else devs[-1 if len(devs) > 1 else 0])
        self.cfg = cfg
        self.cam = cam
        self.merge_lag = merge_lag
        self._step = jax.jit(build_step(cfg, cam, defer_mapping=True))
        self._map = jax.jit(
            lambda s, slot: mapping_pass(cfg, cam, s, slot))
        self._merge = jax.jit(merge_mapping_result)
        self._clear = jax.jit(lambda s: s._replace(
            pending_map_slot=jnp.asarray(-1, jnp.int32)))
        self.state = jax.device_put(init_state(cfg), self.d_track)
        self._inflight = None      # (S0_on_map_device, M, slot)
        self._since_dispatch = 0
        self._queue: list = []

    def step(self, image) -> dict:
        img = jnp.asarray(np.asarray(image, np.float32))
        self.state, metrics = self._step(self.state, img)

        slot = int(self.state.pending_map_slot)   # host sync point
        if slot >= 0:
            self._queue.append(slot)
            self.state = self._clear(self.state)

        if self._inflight is not None:
            self._since_dispatch += 1
            if self._since_dispatch >= self.merge_lag or self._queue:
                self._join()
        if self._inflight is None and self._queue:
            self._dispatch(self._queue.pop(0))
        return {k: np.asarray(v) for k, v in metrics._asdict().items()}

    def _dispatch(self, slot: int):
        s0 = jax.device_put(self.state, self.d_map)
        m = self._map(s0, jnp.asarray(slot, jnp.int32))   # async on d_map
        self._inflight = (s0, m, slot)
        self._since_dispatch = 0

    def _join(self):
        s0, m, _ = self._inflight
        s0_t = jax.device_put(s0, self.d_track)
        m_t = jax.device_put(m, self.d_track)
        self.state = self._merge(self.state, s0_t, m_t)
        self._inflight = None

    def flush(self):
        """Join any in-flight mapping (call at end of scan)."""
        if self._inflight is not None:
            self._join()
        while self._queue:
            self._dispatch(self._queue.pop(0))
            self._join()

    @property
    def status(self) -> int:
        return int(self.state.status)
