"""Batched multi-scan throughput mode (BASELINE.json config: "64 independent
scans vmapped on one host").

The reference is strictly single-scan (one CSfM object); here the whole
engine state is a pytree, so N independent scans are one vmap over the step
function, and the batch axis can additionally be sharded over a device mesh
("scan" axis) with pjit — data parallelism over scans."""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import SfMConfig
from ..engine.state import SfMState, init_state, CameraParams
from ..engine.step import build_step


def init_batched_state(cfg: SfMConfig, batch: int) -> SfMState:
    """A batch of independent engine states with decorrelated RNG keys."""
    proto = init_state(cfg)
    state = jax.tree.map(
        lambda x: jnp.broadcast_to(x, (batch,) + x.shape).copy(), proto)
    return state._replace(key=jax.random.split(jax.random.PRNGKey(7), batch))


def build_batched_step(cfg: SfMConfig, cam: CameraParams):
    """(states [B,...], images [B,H,W]) -> (states, metrics) — one vmapped
    jitted step for the whole fleet of scans."""
    step = build_step(cfg, cam)
    return jax.vmap(step)


def build_sharded_step(cfg: SfMConfig, cam: CameraParams, mesh: Mesh,
                       axis: str = "scan"):
    """The batched step with the batch axis sharded over ``axis`` of the
    mesh: jit moves each scan's state+frame to its device; XLA inserts no
    collectives (scans are independent) so scaling is embarrassingly
    parallel over the mesh's devices."""
    vstep = build_batched_step(cfg, cam)
    return jax.jit(vstep, donate_argnums=(0,))


def shard_batched_state(state: SfMState, mesh: Mesh, axis: str = "scan"
                        ) -> SfMState:
    """Place a batched state with its leading axis sharded over the mesh."""
    shard = NamedSharding(mesh, P(axis))
    return jax.tree.map(lambda x: jax.device_put(x, shard), state)


class MultiScanDriver:
    """Bucketed multi-scan driver: deferred mapping + bucketed
    bootstrap/relocalization dispatch.

    Under vmap, lax.switch/cond branches become selects, so a naive fleet
    step pays bootstrap, relocalization AND the mapping pass for EVERY
    scan EVERY frame.  Here the steady-state vmapped step contains only
    the tracking branch (non-RUNNING scans no-op and keyframe insertions
    flag a pending mapping slot); the driver then dispatches
    - the full step (bootstrap/reloc) over buckets of non-RUNNING scans,
    - the mapping pass over buckets of pending-keyframe scans,
    so expensive rare work scales with how many scans actually need it."""

    def __init__(self, cfg: SfMConfig, cam: CameraParams, batch: int,
                 bucket: int = 8):
        from ..engine.mapping import mapping_pass

        self.cfg = cfg
        self.batch = batch
        self.bucket = bucket
        _track = build_step(cfg, cam, defer_mapping=True,
                            fleet_tracking_only=True)
        _full = build_step(cfg, cam, defer_mapping=True)

        # frames may be staged in uint8 (4x less HBM + host->device
        # traffic than f32 — at flagship resolution a 64-scan fleet's
        # staged chunks would otherwise dominate device memory); cast
        # on device at use
        def track_step(state, image):
            return _track(state, image.astype(jnp.float32))

        def full_step(state, image):
            return _full(state, image.astype(jnp.float32))

        self._track_step = jax.jit(jax.vmap(track_step),
                                   donate_argnums=(0,))

        def full_bucket(states, idx, images):
            sub = jax.tree.map(lambda x: x[idx], states)
            sub, m = jax.vmap(full_step)(sub, images[idx])
            states = jax.tree.map(
                lambda full, new: full.at[idx].set(new), states, sub)
            return states, m

        self._full_bucket = jax.jit(full_bucket, donate_argnums=(0,))

        def map_one(state):
            from ..mapstore import add_descriptors
            slot = state.pending_map_slot

            def run(s):
                # deferred descriptor-vote/color accumulation (see
                # tracking.with_kf's deferred-mode comment)
                sl = jnp.maximum(slot, 0)
                fr = s.kfs.frames
                ids = jnp.where(fr.kp_valid[sl], fr.landmark[sl], -1)
                s = s._replace(lms=add_descriptors(
                    s.lms, ids, fr.desc[sl], colors=fr.color[sl]))
                return mapping_pass(cfg, cam, s, sl)

            st = jax.lax.cond(slot >= 0, run, lambda s: s, state)
            return st._replace(pending_map_slot=jnp.asarray(-1, jnp.int32))

        def map_bucket(states, idx):
            sub = jax.tree.map(lambda x: x[idx], states)
            sub = jax.vmap(map_one)(sub)
            return jax.tree.map(
                lambda full, new: full.at[idx].set(new), states, sub)

        self._map_bucket = jax.jit(map_bucket, donate_argnums=(0,))
        # map-all: when most scans have a pending pass, one vmapped call
        # over the whole fleet beats many buckets (under vmap the cond is a
        # select, so a bucket of 8 costs the same per dispatch as all B)
        self._map_all = jax.jit(jax.vmap(map_one), donate_argnums=(0,))

        # chunked fleet stepping (the throughput mode): one device call
        # runs T frames of the vmapped tracking-only step via lax.scan —
        # no per-frame host dispatch or sync
        def track_chunk(states, images):          # images [T, B, H, W]
            def body(st, img):
                return jax.vmap(track_step)(st, img)
            return jax.lax.scan(body, states, images)

        self._track_chunk = jax.jit(track_chunk, donate_argnums=(0,))

        # chunked full-step bucket: non-RUNNING scans (bootstrap / reloc)
        # re-step through all T frames of the chunk in one call
        def full_chunk(states, idx, images):      # images [T, B, H, W]
            sub = jax.tree.map(lambda x: x[idx], states)

            def body(st, img):
                return jax.vmap(full_step)(st, img)

            sub, _ = jax.lax.scan(body, sub, images[:, idx])
            return jax.tree.map(
                lambda full, new: full.at[idx].set(new), states, sub)

        self._full_chunk = jax.jit(full_chunk, donate_argnums=(0,))
        self._cam = cam
        self._loop_probe_v = None       # compiled lazily on first probe
        self._write_scan = jax.jit(
            lambda states, i, sub: jax.tree.map(
                lambda full, new: full.at[i].set(new), states, sub))
        self.loop_closures = []         # (scan, frame_no, drift, inliers)
        self._corrected_spans = [[] for _ in range(batch)]
        self.states = init_batched_state(cfg, batch)
        # steady-state latch: once most of the fleet has pending mapping
        # slots every chunk, the driver dispatches map_all unconditionally
        # (under vmap a 0-pending map_all costs the same as a full one, and
        # skipping the host-side pending count removes a device sync from
        # the chunk loop)
        self._steady_map = False

    def warmup(self, chunk_images):
        """AOT-compile every dispatch path (tracking chunk, bucketed
        full-step chunk/frame, mapping bucket + map-all) so a cold run's
        first timed steps don't include compilation.  ``chunk_images`` is
        a representative [T, B, H, W] chunk; compilation uses abstract
        shapes only (no state is mutated)."""
        sds = lambda t: jax.tree.map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), t)
        st = sds(self.states)
        ch = sds(chunk_images)
        img = jax.tree.map(lambda s: jax.ShapeDtypeStruct(
            s.shape[1:], s.dtype), ch)
        idx = jax.ShapeDtypeStruct((self.bucket,), jnp.int32)
        self._track_chunk.lower(st, ch).compile()
        self._track_step.lower(st, img).compile()
        self._full_chunk.lower(st, idx, ch).compile()
        self._full_bucket.lower(st, idx, img).compile()
        self._map_bucket.lower(st, idx).compile()
        self._map_all.lower(st).compile()

    def step(self, images) -> "StepMetrics":
        """One fleet step: vmapped tracking + bucketed dispatch of
        bootstrap/reloc (non-RUNNING scans) and mapping (pending slots)."""
        status_before = np.asarray(self.states.status)
        self.states, metrics = self._track_step(self.states, images)

        # non-RUNNING scans re-step through the full (bootstrap/reloc) path
        # with the same frame (the fleet no-op did not consume it)
        not_running = status_before != 1
        for sel in self._buckets(np.nonzero(not_running)[0]):
            self.states, _ = self._full_bucket(self.states,
                                               jnp.asarray(sel), images)

        self._dispatch_mapping()
        return metrics

    def step_chunk(self, images) -> "StepMetrics":
        """T frames for the whole fleet in ONE device call (the throughput
        mode): images [T, B, H, W].  Per chunk the host does one [B] status
        read, the chunked tracking call, bucketed full-step chunks for the
        scans that were not RUNNING at chunk start (they no-op inside the
        tracking chunk without consuming frames), and one mapping dispatch.

        T must be <= cfg.keyframe_time_lag so a scan inserts at most one
        keyframe per chunk (the deferred-mapping slot holds one entry).
        A scan that goes LOST mid-chunk skips the remaining frames of that
        chunk (real-time drop semantics; the reference blocks forever on
        LOST, CSfM.cpp:536) and relocalizes from the next chunk on."""
        T = images.shape[0]
        assert T <= self.cfg.keyframe_time_lag, \
            "chunk longer than the keyframe lag can overflow the pending slot"
        # snapshot the status BEFORE dispatching (device-side copy, no
        # sync — the tracking call donates the state buffers, so reading
        # the original array after dispatch would hit a deleted buffer);
        # the host fetch below then overlaps with the queued tracking
        # chunk instead of stalling the loop on the previous chunk's tail
        status_dev = jnp.copy(self.states.status)
        self.states, metrics = self._track_chunk(self.states, images)
        status_before = np.asarray(status_dev)

        not_running = status_before != 1
        for sel in self._buckets(np.nonzero(not_running)[0]):
            self.states = self._full_chunk(self.states, jnp.asarray(sel),
                                           images)
        self._dispatch_mapping()
        return metrics

    def _dispatch_mapping(self):
        if self._steady_map:
            # steady state: dispatch unconditionally, no host sync
            self.states = self._map_all(self.states)
            return
        pending = np.asarray(self.states.pending_map_slot >= 0)
        n = int(pending.sum())
        if n == 0:
            return
        # under vmap every scan pays the selected-in mapping pass, so the
        # cost of one dispatch is ~batch-proportional compute regardless of
        # bucket size; buckets only pay off when few scans are pending
        if n >= max(self.batch // 3, self.bucket):
            self._steady_map = True
            self.states = self._map_all(self.states)
        else:
            for sel in self._buckets(np.nonzero(pending)[0]):
                self.states = self._map_bucket(self.states, jnp.asarray(sel))

    def probe_loops(self, probes=None, slots=None) -> list:
        """Fleet loop-closure pass (VERDICT r4 missing #4: the fleet
        silently lost the loop subsystem the single-scan engine has).

        ONE vmapped probe call covers the whole fleet (each scan's newest
        keyframe globally matched against its own old landmarks +
        PnP'd — engine/loop.py); detected closures (rare events) are then
        corrected per scan on the host (close_loop + 2x global BA, the
        same path SfMEngine.probe_loop_closure takes) and written back
        into the batch.  Call every ~cfg.loop_detect_every keyframes'
        worth of chunks; the probe itself costs one fleet-wide matcher
        pass.  ``probes``/``slots`` are injectable for tests.

        Returns the list of (scan, frame_no, drift_m, n_inliers) closed
        this call (also appended to ``self.loop_closures``)."""
        from ..engine.loop import (build_loop_probe, close_loop,
                                   _start_frame)
        from ..engine.global_ba import run_global_ba

        if probes is None:
            if self._loop_probe_v is None:
                probe = build_loop_probe(self.cfg, self._cam)

                def probe_newest(state):
                    # newest valid keyframe slot of this scan
                    fns = jnp.where(state.kfs.valid,
                                    state.kfs.frames.frame_no, -1)
                    slot = jnp.argmax(fns)
                    p = probe(state, slot)
                    # no probe without >= 2 keyframes
                    ok = p.ok & (jnp.sum(state.kfs.valid) >= 2) \
                        & (state.status == 1)
                    return p._replace(ok=ok), slot

                self._loop_probe_v = jax.jit(jax.vmap(probe_newest))
            probes, slots = self._loop_probe_v(self.states)
        ok = np.asarray(probes.ok)
        closed = []
        for i in np.nonzero(ok)[0]:
            i = int(i)
            sub = jax.tree.map(lambda x: x[i], self.states)
            probe_i = jax.tree.map(lambda x: x[i], probes)
            slot_i = int(np.asarray(slots[i]))
            fns_i = np.asarray(sub.kfs.frames.frame_no)
            valid_i = np.asarray(sub.kfs.valid)
            span = (_start_frame(fns_i, valid_i, probe_i),
                    int(fns_i[slot_i]))
            sub = close_loop(self.cfg, self._cam, sub, slot_i, probe_i,
                             corrected_spans=self._corrected_spans[i])
            self._corrected_spans[i].append(span)
            for _ in range(2):
                sub, _stats = run_global_ba(self.cfg, self._cam, sub)
            self.states = self._write_scan(self.states,
                                           jnp.asarray(i), sub)
            fn = int(np.asarray(sub.kfs.frames.frame_no[slot_i]))
            entry = (i, fn, float(np.asarray(probe_i.drift)),
                     int(np.asarray(probe_i.n_inliers)))
            closed.append(entry)
            self.loop_closures.append(entry)
        return closed

    def _buckets(self, idx):
        # pad by cycling the selection: duplicated entries gather the SAME
        # pre-state and compute identical results, so the duplicate scatter
        # writes the same value — one step applied once, not twice
        for start in range(0, len(idx), self.bucket):
            sel = idx[start:start + self.bucket]
            if len(sel):
                yield np.resize(sel, self.bucket)
