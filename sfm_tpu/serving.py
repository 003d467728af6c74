"""Streaming scan service: the server-side analogue of the reference's iOS
live-camera shell (SURVEY.md §2.8 — a streaming client API that feeds
frames to a possibly remote accelerator engine).

A thin length-prefixed TCP protocol (no external deps):

  client -> server:  INIT json {height, width, fx, fy, cx, cy, dist?,
                                config overrides?}
                     FRAME  [dtype u8][channels u8][pad u16] + raw pixels
                            (dtype 0 = float32, 1 = uint8;
                             channels 1 = grayscale, 3 = RGB — RGB keeps
                             real landmark colors and, with
                             guidance_enabled, drives scan guidance)
                     FRAMES same header with pad = frame count: a CHUNK
                            of frames processed in ONE device call (the
                            throughput path for offline clients)
                     GET_CLOUD / CLOSE
  server -> client:  per-frame metrics json (status, counts, pose, ...);
                     a json LIST for FRAMES
                     point cloud (xyz f32 + rgb u8) on GET_CLOUD

Messages are [4-byte BE length][1-byte type][payload].  The server owns one
SfMEngine per connection; frames stream through the jitted step on the
device the server runs next to."""

from __future__ import annotations

import json
import socket
import socketserver
import struct
import threading
from typing import Optional

import numpy as np

MSG_INIT = 1
MSG_FRAME = 2
MSG_METRICS = 3
MSG_GET_CLOUD = 4
MSG_CLOUD = 5
MSG_CLOSE = 6
MSG_ERROR = 7
MSG_FRAMES = 8      # chunked frames (one device call)

DTYPE_F32 = 0
DTYPE_U8 = 1


def _frame_header(dtype_code: int, channels: int, count: int = 0) -> bytes:
    return struct.pack(">BBH", dtype_code, channels, count)


def _decode_frames(payload: bytes, shape, chunked: bool) -> np.ndarray:
    """[dtype u8][channels u8][count u16] + raw pixels -> [N, H, W(, 3)]
    float32 (uint8 payloads are promoted; the engine normalizes)."""
    dtype_code, channels, count = struct.unpack(">BBH", payload[:4])
    if dtype_code not in (DTYPE_F32, DTYPE_U8):
        raise ValueError(f"unknown frame dtype code {dtype_code}")
    if channels not in (1, 3):
        raise ValueError(f"unsupported channel count {channels}")
    n = count if chunked else 1
    dt = np.float32 if dtype_code == DTYPE_F32 else np.uint8
    arr = np.frombuffer(payload[4:], dt)
    shp = (n,) + tuple(shape) + ((3,) if channels == 3 else ())
    expect = int(np.prod(shp))
    if arr.size != expect:
        raise ValueError(f"frame payload holds {arr.size} px, expected "
                         f"{expect} for {shp} {np.dtype(dt).name}")
    return arr.reshape(shp).astype(np.float32)


def _send(sock, msg_type: int, payload: bytes) -> None:
    sock.sendall(struct.pack(">IB", len(payload), msg_type) + payload)


def _recv_exact(sock, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


def _recv(sock):
    head = _recv_exact(sock, 5)
    length, msg_type = struct.unpack(">IB", head)
    return msg_type, _recv_exact(sock, length)


class _ScanHandler(socketserver.BaseRequestHandler):
    def handle(self):
        from .config import SfMConfig
        from .engine import SfMEngine

        eng: Optional[SfMEngine] = None
        shape = None
        try:
            while True:
                msg_type, payload = _recv(self.request)
                if msg_type == MSG_INIT:
                    spec = json.loads(payload.decode())
                    h, w = int(spec["height"]), int(spec["width"])
                    shape = (h, w)
                    overrides = spec.get("config", {})
                    cfg = SfMConfig(image_height=h, image_width=w,
                                    **overrides)
                    K = np.array([[spec["fx"], 0, spec["cx"]],
                                  [0, spec["fy"], spec["cy"]],
                                  [0, 0, 1]], np.float32)
                    eng = SfMEngine(K, (h, w), spec.get("dist"), cfg)
                    _send(self.request, MSG_METRICS,
                          json.dumps({"ready": True}).encode())
                elif msg_type == MSG_FRAME:
                    if eng is None:
                        raise ValueError("FRAME before INIT")
                    frame = _decode_frames(payload, shape, chunked=False)[0]
                    m = eng.add_frame(frame)
                    out = {k: (v.tolist() if hasattr(v, "tolist") else v)
                           for k, v in m.items()}
                    _send(self.request, MSG_METRICS,
                          json.dumps(out).encode())
                elif msg_type == MSG_FRAMES:
                    if eng is None:
                        raise ValueError("FRAMES before INIT")
                    frames = _decode_frames(payload, shape, chunked=True)
                    ms = eng.add_frames(frames)
                    out = [{k: (v.tolist() if hasattr(v, "tolist") else v)
                            for k, v in m.items()} for m in ms]
                    _send(self.request, MSG_METRICS,
                          json.dumps(out).encode())
                elif msg_type == MSG_GET_CLOUD:
                    pts, cols = eng.get_reconstruction()
                    blob = struct.pack(">I", len(pts)) + \
                        pts.astype("<f4").tobytes() + cols.tobytes()
                    _send(self.request, MSG_CLOUD, blob)
                elif msg_type == MSG_CLOSE:
                    return
        except (ConnectionError, OSError):
            return
        except Exception as e:  # report engine errors to the client
            try:
                _send(self.request, MSG_ERROR, str(e).encode())
            except OSError:
                pass


class ScanServer:
    """Threaded TCP scan service.  ``with ScanServer(port) as s: ...``"""

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        self._srv = socketserver.ThreadingTCPServer(
            (host, port), _ScanHandler, bind_and_activate=True)
        self._srv.daemon_threads = True
        self.port = self._srv.server_address[1]
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._srv.shutdown()
        self._srv.server_close()


class ScanClient:
    """Client for ScanServer: the embeddable mobile-app-facing API."""

    def __init__(self, host: str, port: int):
        self._sock = socket.create_connection((host, port))

    def init(self, height, width, fx, fy, cx, cy, dist=None, config=None):
        spec = dict(height=height, width=width, fx=fx, fy=fy, cx=cx, cy=cy)
        if dist is not None:
            spec["dist"] = list(dist)
        if config:
            spec["config"] = config
        _send(self._sock, MSG_INIT, json.dumps(spec).encode())
        return self._expect(MSG_METRICS)

    @staticmethod
    def _encode(frames: np.ndarray, count: int = 0) -> bytes:
        """uint8 stays uint8 on the wire (4x less than f32 for camera
        frames); anything else ships as float32.  [..., 3] is RGB."""
        frames = np.ascontiguousarray(frames)
        if frames.dtype != np.uint8:
            frames = frames.astype(np.float32)
        code = DTYPE_U8 if frames.dtype == np.uint8 else DTYPE_F32
        channels = 3 if frames.shape[-1] == 3 and frames.ndim >= 3 else 1
        return _frame_header(code, channels, count) + frames.tobytes()

    def add_frame(self, frame: np.ndarray) -> dict:
        """One frame: [H, W] grayscale or [H, W, 3] RGB, uint8 or float."""
        _send(self._sock, MSG_FRAME, self._encode(np.asarray(frame)))
        return self._expect(MSG_METRICS)

    def add_frames(self, frames: np.ndarray) -> list:
        """A chunk of frames ([N, H, W] or [N, H, W, 3]) processed in one
        device call server-side; returns the per-frame metrics list."""
        frames = np.asarray(frames)
        _send(self._sock, MSG_FRAMES,
              self._encode(frames, count=frames.shape[0]))
        return self._expect(MSG_METRICS)

    def get_cloud(self):
        _send(self._sock, MSG_GET_CLOUD, b"")
        msg_type, payload = _recv(self._sock)
        if msg_type != MSG_CLOUD:
            raise RuntimeError(payload.decode())
        (n,) = struct.unpack(">I", payload[:4])
        xyz = np.frombuffer(payload[4:4 + 12 * n], "<f4").reshape(n, 3)
        rgb = np.frombuffer(payload[4 + 12 * n:4 + 15 * n],
                            np.uint8).reshape(n, 3)
        return xyz.copy(), rgb.copy()

    def close(self):
        try:
            _send(self._sock, MSG_CLOSE, b"")
        finally:
            self._sock.close()

    def _expect(self, want) -> dict:
        msg_type, payload = _recv(self._sock)
        if msg_type == MSG_ERROR:
            raise RuntimeError(payload.decode())
        if msg_type != want:
            raise RuntimeError(f"unexpected message type {msg_type}")
        return json.loads(payload.decode())
