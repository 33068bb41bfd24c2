"""Live DCA1000 capture: raw-mode UDP packet stream -> whole radar frames
(counterpart of `hupr_tpu/data/capture.py`).

The reference only consumes captures as completed adc_data.bin files
(reference preprocessing/process_iwr1843.py:91-104); this is the LIVE
ingest path for streaming serving: feed datagrams (from a socket or a pcap
replay), pop (frame_samples,) int16 frames, split them into int16 I/Q
planes (stream_to_iq_planes) and hand them to
engine/streaming.StreamingPoseEstimator, which decodes on the card.

Reassembly semantics (native/dca1000.cc, mirrored by the NumPy engine):
payloads land at the stream byte offset carried in each packet's 48-bit
header field, so reordering and duplication are harmless; spans never
received by consume time read as zeros (one lost packet corrupts one frame
span instead of shifting every later sample — TI's own parsers do the
same); a bounded ring drops the OLDEST unread frames on overflow because a
live consumer wants fresh data.

Both engines keep two stat quirks of the shared C++ source, so that they
stay equal to it stat for stat: after a backward resync (a capture-card
restart) the highest sequence number seen is not reset, so every later
packet counts as `reordered`; and a far-behind packet that is rejected as a
resync candidate counts in both `rejected` and `late_bytes`.

The C++ engine is built with g++ from the shared `native/dca1000.cc` at
first use into `build/hupr_tpu_torch/` at the root of the checkout (the same
atomic rename, and never loading a .so older than its source, as
data/native_loader.py). `native=None` picks the C++ engine when it builds
and the NumPy engine otherwise; `native=True` raises when the C++ engine is
not there; `native=False` forces the NumPy engine (bit-identical, pinned by
tests/test_torch_capture.py).
"""

from __future__ import annotations

import ctypes
import os
import socket
import subprocess
import threading
from typing import Iterator, Optional

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "dca1000.cc")
_BUILD_DIR = os.path.join(_REPO_ROOT, "build", "hupr_tpu_torch")
_LIB_PATH = os.path.join(_BUILD_DIR, "libhupr_dca1000.so")

HEADER_BYTES = 10          # uint32 seq + uint48 byte offset
DEFAULT_PAYLOAD = 1456     # DCA1000 raw-mode payload size

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    """Compile to a process-unique temp file and atomically rename into
    place, so that two processes building at once never interleave writes
    into the .so another process is dlopen-ing."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
           "-o", tmp, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _LIB_PATH)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError, OSError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """The capture library, built on demand; None when unavailable. Never
    loads a .so older than its source (same policy as native_loader)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB_PATH) or (
                os.path.exists(_SRC)
                and os.path.getmtime(_SRC) > os.path.getmtime(_LIB_PATH)):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
            lib.hupr_cap_create.restype = ctypes.c_void_p
            lib.hupr_cap_create.argtypes = [ctypes.c_long, ctypes.c_long]
            lib.hupr_cap_destroy.argtypes = [ctypes.c_void_p]
            lib.hupr_cap_feed.restype = ctypes.c_long
            lib.hupr_cap_feed.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long]
            lib.hupr_cap_frames_ready.restype = ctypes.c_long
            lib.hupr_cap_frames_ready.argtypes = [ctypes.c_void_p]
            lib.hupr_cap_read_frame.restype = ctypes.c_int
            lib.hupr_cap_read_frame.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_long)]
            lib.hupr_cap_stats.argtypes = [ctypes.c_void_p] + \
                [ctypes.POINTER(ctypes.c_long)] * 7
        except (OSError, AttributeError):
            return None
        _lib = lib
        return _lib


def native_available() -> bool:
    return get_lib() is not None


def packetize(stream: np.ndarray, payload_bytes: int = DEFAULT_PAYLOAD,
              first_seq: int = 1) -> list[bytes]:
    """Split an int16 stream into raw-mode datagrams (test/replay helper —
    the inverse of reassembly, matching the DCA1000's own framing)."""
    raw = np.ascontiguousarray(stream, dtype=np.int16).tobytes()
    pkts = []
    for i, off in enumerate(range(0, len(raw), payload_bytes)):
        seq = np.uint32(first_seq + i).tobytes()
        off48 = int(off).to_bytes(6, "little")
        pkts.append(seq + off48 + raw[off:off + payload_bytes])
    return pkts


def stream_to_iq_planes(frame: np.ndarray, params) -> tuple:
    """One reassembled (frame_samples,) int16 frame -> (re, im) int16
    planes of shape (RX, chirps, ADC) — the same layout decode_dca1000
    produces, WITHOUT the float cast, so the streaming estimator's
    half-width int16 ingest path (engine/streaming.py process_frame
    (re, im) tuples) gets sensor-native bytes end to end."""
    p = params
    quad = frame.reshape(-1, p.num_lanes * 2)
    lane_i = quad[:, 0:2].reshape(-1, p.num_rx, p.num_adc_samples)
    lane_q = quad[:, 2:4].reshape(-1, p.num_rx, p.num_adc_samples)
    return (np.ascontiguousarray(np.transpose(lane_i, (1, 0, 2))),
            np.ascontiguousarray(np.transpose(lane_q, (1, 0, 2))))


class _NumpyEngine:
    """Pure-NumPy twin of native/dca1000.cc (same ring/zero-fill/drop-oldest
    semantics, same stats)."""

    def __init__(self, frame_bytes: int, ring_frames: int):
        self.frame_bytes = frame_bytes
        self.capacity = frame_bytes * ring_frames
        self.ring = np.zeros(self.capacity, np.uint8)
        self.base = 0
        self.watermark = 0
        self.packets = self.bytes = self.late_bytes = 0
        self.overflow_frames = self.reordered = 0
        self.rejected = self.resyncs = 0
        self._resync_candidate = -1
        self._last_seq = 0

    def _drop_oldest(self):
        idx = (self.base + np.arange(self.frame_bytes)) % self.capacity
        self.ring[idx] = 0
        self.base += self.frame_bytes
        self.watermark = max(self.watermark, self.base)

    def _try_resync(self, off: int) -> bool:
        """Two-packet confirmation for a far offset (ahead OR behind): the
        first sighting is remembered + rejected; a second DISTINCT offset
        agreeing with it (strictly ahead of the candidate, within one ring
        span) performs the bounded resync."""
        if (self._resync_candidate >= 0
                and self._resync_candidate < off
                <= self._resync_candidate + self.capacity):
            self.overflow_frames += ((self.watermark - self.base)
                                     // self.frame_bytes)
            self.ring[:] = 0
            self.base = (off // self.frame_bytes) * self.frame_bytes
            self.watermark = self.base
            self._resync_candidate = -1
            self.resyncs += 1
            # _last_seq is left as it was, as native/dca1000.cc leaves it
            # (the first quirk in the module docstring)
            return True
        self._resync_candidate = off
        self.rejected += 1
        return False

    def feed(self, pkt: bytes) -> int:
        if len(pkt) < HEADER_BYTES:
            return -1
        seq = int.from_bytes(pkt[:4], "little")
        off = int.from_bytes(pkt[4:10], "little")
        payload = np.frombuffer(pkt, np.uint8, offset=HEADER_BYTES)
        n = payload.size
        self.packets += 1
        if self._last_seq and seq <= self._last_seq:
            self.reordered += 1
        self._last_seq = max(self._last_seq, seq)
        if off + n <= self.base:
            # a DCA1000 restart resets the stream's byte counter to 0, so
            # every post-restart packet lands far BELOW base and would read
            # as late forever — same two-packet confirmation as far-ahead,
            # then base snaps BACKWARDS to the restarted stream. Near-behind
            # packets (within one ring) stay plain late/duplicates.
            if off + self.capacity < self.base and self._try_resync(off):
                pass  # resynced: fall through to the normal placement path
            else:
                # a far-behind first sighting lands here too, after
                # _try_resync counted it as rejected (the second quirk)
                self.late_bytes += n
                return 0
        if off < self.base:
            skip = self.base - off
            self.late_bytes += skip
            payload, off, n = payload[skip:], self.base, n - skip
        # far-ahead offsets (corrupted header OR a genuine forward jump)
        # need a second agreeing packet — STRICTLY ahead of the candidate,
        # so a UDP-duplicated copy of the one corrupted datagram can't
        # self-confirm — before the bounded resync moves base; a lone
        # corrupted offset must not wipe the ring or spin the drop loop
        # (see native/dca1000.cc, the twin of this logic)
        if off > self.watermark + self.capacity:
            if not self._try_resync(off):
                return 0
        else:
            self._resync_candidate = -1
        # bounded: off <= watermark + capacity => at most ring_frames+1 drops
        while off + n > self.base + self.capacity:
            self._drop_oldest()
            self.overflow_frames += 1
        idx = (off + np.arange(n)) % self.capacity
        self.ring[idx] = payload
        self.bytes += n
        self.watermark = max(self.watermark, off + n)
        return n

    def frames_ready(self) -> int:
        return (self.watermark - self.base) // self.frame_bytes

    def read_frame(self) -> Optional[tuple]:
        if self.watermark - self.base < self.frame_bytes:
            return None
        idx = (self.base + np.arange(self.frame_bytes)) % self.capacity
        out = self.ring[idx].copy()
        frame_idx = self.base // self.frame_bytes
        self._drop_oldest()
        return out, frame_idx

    def stats(self) -> dict:
        return dict(packets=self.packets, bytes=self.bytes,
                    late_bytes=self.late_bytes,
                    overflow_frames=self.overflow_frames,
                    reordered=self.reordered, rejected=self.rejected,
                    resyncs=self.resyncs)


class _NativeEngine:
    def __init__(self, lib, frame_bytes: int, ring_frames: int):
        self._lib = lib
        self.frame_bytes = frame_bytes
        self._h = lib.hupr_cap_create(frame_bytes, ring_frames)
        if not self._h:
            raise MemoryError("hupr_cap_create failed")

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.hupr_cap_destroy(h)

    def feed(self, pkt: bytes) -> int:
        return self._lib.hupr_cap_feed(self._h, pkt, len(pkt))

    def frames_ready(self) -> int:
        return self._lib.hupr_cap_frames_ready(self._h)

    def read_frame(self) -> Optional[tuple]:
        out = np.empty(self.frame_bytes, np.uint8)
        idx = ctypes.c_long()
        ok = self._lib.hupr_cap_read_frame(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.byref(idx))
        return (out, idx.value) if ok else None

    def stats(self) -> dict:
        vals = [ctypes.c_long() for _ in range(7)]
        self._lib.hupr_cap_stats(self._h, *[ctypes.byref(v) for v in vals])
        keys = ("packets", "bytes", "late_bytes", "overflow_frames",
                "reordered", "rejected", "resyncs")
        return dict(zip(keys, (v.value for v in vals)))


class PacketReassembler:
    """Datagrams in, (frame_samples,) int16 frames out.

    `frame_samples`: int16 samples per radar frame
    (ops/dsp.RadarParams: num_rx * num_chirp * num_adc_samples * 2 —
    data/adc.ADCFrameSource.frame_samples). `ring_frames` bounds memory;
    `native=None` auto-selects the C++ engine with NumPy fallback."""

    def __init__(self, frame_samples: int, ring_frames: int = 16,
                 native: Optional[bool] = None):
        self.frame_samples = frame_samples
        frame_bytes = frame_samples * 2
        lib = get_lib() if native in (None, True) else None
        if native is True and lib is None:
            raise RuntimeError("native capture engine unavailable "
                               "(no toolchain?)")
        self._eng = (_NativeEngine(lib, frame_bytes, ring_frames) if lib
                     else _NumpyEngine(frame_bytes, ring_frames))
        self.is_native = isinstance(self._eng, _NativeEngine)

    def feed(self, datagram: bytes) -> int:
        """Accepted payload bytes (0 = stale packet, -1 = malformed)."""
        return self._eng.feed(datagram)

    def frames_ready(self) -> int:
        return self._eng.frames_ready()

    def read_frame(self) -> Optional[np.ndarray]:
        """Oldest buffered frame as (frame_samples,) int16, or None."""
        got = self.read_frame_indexed()
        return None if got is None else got[1]

    def read_frame_indexed(self) -> Optional[tuple]:
        """(frame_index, frame) of the oldest buffered frame, or None.
        The index is the frame's absolute position in the capture stream
        (byte offset / frame bytes) — NOT contiguous across overflow drops
        or resyncs, which is exactly what lets a consumer re-align two
        independent per-view streams after an asymmetric drop
        (hupr_tpu_torch/scripts/live_serve.py)."""
        got = self._eng.read_frame()
        if got is None:
            return None
        raw, idx = got
        return idx, raw.view(np.int16)

    def frames(self) -> Iterator[np.ndarray]:
        """Drain every currently-complete frame."""
        while True:
            f = self.read_frame()
            if f is None:
                return
            yield f

    def stats(self) -> dict:
        return self._eng.stats()


class UDPCaptureSource:
    """Background UDP listener feeding a PacketReassembler — the live
    topology: DCA1000 data port -> socket -> reassembler -> frames() ->
    the streaming estimator on the card.

        src = UDPCaptureSource(frame_samples, port=4098)
        with src:                      # binds + starts the reader thread
            for frame in src.frames(n=100):
                ...

    `frames()` blocks on a condition variable, not a poll loop."""

    def __init__(self, frame_samples: int, port: int, host: str = "0.0.0.0",
                 ring_frames: int = 16, native: Optional[bool] = None,
                 recv_bytes: int = 1 << 16):
        self.reassembler = PacketReassembler(frame_samples,
                                             ring_frames=ring_frames,
                                             native=native)
        self._addr = (host, port)
        self._recv_bytes = recv_bytes
        self._sock: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None
        self._cv = threading.Condition()
        self._closed = False

    @property
    def port(self) -> int:
        assert self._sock is not None, "not started"
        return self._sock.getsockname()[1]

    def __enter__(self):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        # the DCA1000 bursts ~700 packets/frame; a deep kernel buffer rides
        # out reader-thread scheduling gaps (the OS may clamp to
        # net.core.rmem_max — drops then show up in stats as missing bytes)
        try:
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                                  8 << 20)
        except OSError:
            pass
        self._sock.bind(self._addr)
        self._sock.settimeout(0.2)   # lets the thread observe _closed
        self._thread = threading.Thread(target=self._reader, daemon=True)
        self._thread.start()
        return self

    def _reader(self):
        while not self._closed:
            try:
                pkt, _ = self._sock.recvfrom(self._recv_bytes)
            except socket.timeout:
                continue
            except OSError:
                return
            with self._cv:
                self.reassembler.feed(pkt)
                self._cv.notify_all()

    def frames(self, n: int, timeout: float = 10.0) -> Iterator[np.ndarray]:
        """Yield the next `n` frames; raises TimeoutError if no new frame
        completes within `timeout` seconds."""
        for _, frame in self.frames_indexed(n, timeout):
            yield frame

    def frames_indexed(self, n: int,
                       timeout: float = 10.0) -> Iterator[tuple]:
        """Yield (frame_index, frame) for the next `n` frames; the index is
        the frame's absolute stream position (gaps mark drops/resyncs).
        Raises TimeoutError if no new frame completes within `timeout`."""
        import time
        for _ in range(n):
            deadline = time.monotonic() + timeout
            with self._cv:
                while True:
                    got = self.reassembler.read_frame_indexed()
                    if got is not None:
                        break
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError(
                            f"no frame within {timeout}s "
                            f"(stats={self.reassembler.stats()})")
                    self._cv.wait(remaining)
            yield got

    def __exit__(self, *exc):
        self._closed = True
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        if self._sock is not None:
            self._sock.close()
        return False
