"""The port's live DCA1000 capture (hupr_tpu_torch/data/capture.py) against
hupr_tpu's, on the CPU: the properties of tests/test_capture.py on both of
the port's engines (NumPy and the C++ one built from the shared
native/dca1000.cc); a differential on seeded adversarial schedules where
the port's two engines and the JAX package's two return equal feed
results, frames, indices and stats() after every packet, the two stat
quirks of the shared source included (a backward resync leaves the last
sequence number, so `reordered` climbs; a rejected far-behind packet counts
in `rejected` and `late_bytes`); stream_to_iq_planes; and one loopback
UDPCaptureSource."""

import socket

import numpy as np
import pytest

from hupr_tpu.data import capture as jax_capture
from hupr_tpu.ops.dsp import RadarParams as JaxRadarParams
from hupr_tpu_torch.data import capture
from hupr_tpu_torch.data.capture import (DEFAULT_PAYLOAD, PacketReassembler,
                                         UDPCaptureSource, packetize)
from hupr_tpu_torch.ops.dsp import RadarParams

FRAME_SAMPLES = 2048          # small synthetic geometry: 4 KiB frames
FRAME_BYTES = 2 * FRAME_SAMPLES
PAYLOAD = 1000                # not a divisor of frame bytes: packets straddle
JUMP = 1000 * FRAME_BYTES     # a forward jump of 1000 frames, in bytes


def _stream(frames, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(-3000, 3000,
                        frames * FRAME_SAMPLES).astype(np.int16)


def _moved(pkt, off_shift=0, seq=None):
    """`pkt` with its byte offset moved by `off_shift` and, when given, its
    sequence number replaced."""
    head = pkt[:4] if seq is None else int(seq).to_bytes(4, "little")
    off = int.from_bytes(pkt[4:10], "little") + off_shift
    return head + off.to_bytes(6, "little") + pkt[10:]


def _drain(r):
    got = []
    while True:
        f = r.read_frame_indexed()
        if f is None:
            return got
        got.append(f)


ENGINES = [False] + ([True] if capture.native_available() else [])


@pytest.fixture(params=ENGINES, ids=lambda n: "native" if n else "numpy")
def engine(request):
    return request.param


def test_native_engine_builds_into_the_port_build_dir():
    """The C++ engine builds here (g++ is on this machine) into
    build/hupr_tpu_torch/, and native=True gets it."""
    assert capture.native_available()
    assert capture._LIB_PATH.endswith("build/hupr_tpu_torch/"
                                      "libhupr_dca1000.so")
    assert PacketReassembler(FRAME_SAMPLES, native=True).is_native
    assert not PacketReassembler(FRAME_SAMPLES, native=False).is_native
    assert PacketReassembler(FRAME_SAMPLES).is_native     # native=None


def test_native_true_raises_without_the_engine(monkeypatch):
    monkeypatch.setattr(capture, "get_lib", lambda: None)
    with pytest.raises(RuntimeError, match="native capture engine"):
        PacketReassembler(FRAME_SAMPLES, native=True)
    assert not PacketReassembler(FRAME_SAMPLES).is_native


def test_in_order_reassembly_exact(engine):
    stream = _stream(3)
    r = PacketReassembler(FRAME_SAMPLES, native=engine)
    for pkt in packetize(stream, PAYLOAD):
        assert r.feed(pkt) > 0
    got = list(r.frames())
    assert len(got) == 3 and all(f.dtype == np.int16 for f in got)
    np.testing.assert_array_equal(np.concatenate(got), stream)
    s = r.stats()
    assert s["bytes"] == stream.nbytes and s["late_bytes"] == 0
    assert s["overflow_frames"] == 0 and s["reordered"] == 0


def test_reordered_packets_exact(engine):
    stream = _stream(2, seed=1)
    pkts = packetize(stream, PAYLOAD)
    pkts[1], pkts[2] = pkts[2], pkts[1]
    r = PacketReassembler(FRAME_SAMPLES, native=engine)
    for pkt in pkts:
        r.feed(pkt)
    np.testing.assert_array_equal(np.concatenate(list(r.frames())), stream)
    assert r.stats()["reordered"] >= 1


def test_dropped_packet_zero_fills_its_span_only(engine):
    stream = _stream(2, seed=2)
    pkts = packetize(stream, PAYLOAD)
    del pkts[1]                        # lose bytes [PAYLOAD, 2*PAYLOAD)
    r = PacketReassembler(FRAME_SAMPLES, native=engine)
    for pkt in pkts:
        r.feed(pkt)
    want = stream.copy()
    want[PAYLOAD // 2:PAYLOAD] = 0     # int16 indices of the lost span
    np.testing.assert_array_equal(np.concatenate(list(r.frames())), want)


def test_duplicate_packet_harmless(engine):
    stream = _stream(1, seed=3)
    r = PacketReassembler(FRAME_SAMPLES, native=engine)
    for pkt in packetize(stream, PAYLOAD):
        r.feed(pkt)
        r.feed(pkt)                    # duplicate every datagram
    np.testing.assert_array_equal(np.concatenate(list(r.frames())), stream)


def test_overflow_drops_oldest_keeps_newest(engine):
    frames = 6
    stream = _stream(frames, seed=4)
    r = PacketReassembler(FRAME_SAMPLES, ring_frames=2, native=engine)
    for pkt in packetize(stream, PAYLOAD):
        r.feed(pkt)
    got = list(r.frames())
    assert len(got) == 2
    np.testing.assert_array_equal(np.concatenate(got),
                                  stream[(frames - 2) * FRAME_SAMPLES:])
    assert r.stats()["overflow_frames"] == frames - 2


def test_stale_and_malformed_packets(engine):
    pkts = packetize(_stream(2, seed=5), PAYLOAD)
    r = PacketReassembler(FRAME_SAMPLES, native=engine)
    for pkt in pkts:
        r.feed(pkt)
    assert r.read_frame() is not None   # consume frame 0: base advances
    assert r.feed(pkts[0]) == 0         # now entirely below base -> stale
    assert r.stats()["late_bytes"] == PAYLOAD
    assert r.feed(b"\x01\x02\x03") == -1


def test_corrupted_offset_rejected_stream_survives(engine):
    """A lone datagram with a garbage 48-bit offset is dropped, and so is
    a duplicate of it: confirming a resync takes a second, strictly
    greater, agreeing offset."""
    stream = _stream(2, seed=10)
    pkts = packetize(stream, PAYLOAD)
    r = PacketReassembler(FRAME_SAMPLES, native=engine)
    r.feed(pkts[0])
    evil = pkts[0][:4] + int(1 << 40).to_bytes(6, "little") + b"\xff" * 64
    assert r.feed(evil) == 0                  # first sighting: held back
    assert r.feed(evil) == 0                  # duplicate: must NOT confirm
    for pkt in pkts[1:]:                      # the real stream continues
        assert r.feed(pkt) > 0
    np.testing.assert_array_equal(np.concatenate(list(r.frames())), stream)
    s = r.stats()
    assert s["resyncs"] == 0 and s["rejected"] == 2


def test_confirmed_forward_jump_resyncs(engine):
    frames_ahead = JUMP // FRAME_BYTES
    stream = _stream(2, seed=11)
    r = PacketReassembler(FRAME_SAMPLES, native=engine)
    pkts = packetize(stream, PAYLOAD)
    r.feed(pkts[0])                           # some pre-jump traffic
    far = [_moved(p, JUMP) for p in pkts]
    assert r.feed(far[0]) == 0                # first sighting: held back
    for pkt in far[1:]:                       # second agrees -> resync
        assert r.feed(pkt) > 0
    got = _drain(r)
    # far[0] was held back, so frame 0 of the far region has a zero span
    assert [i for i, _ in got] == [frames_ahead, frames_ahead + 1]
    np.testing.assert_array_equal(got[1][1], stream[FRAME_SAMPLES:])
    s = r.stats()
    assert s["resyncs"] == 1 and s["rejected"] == 1


def test_capture_card_restart_resyncs_backwards(engine):
    pre = _stream(2, seed=14)
    r = PacketReassembler(FRAME_SAMPLES, native=engine)
    for pkt in packetize(pre, PAYLOAD):       # one forward resync to +JUMP
        r.feed(_moved(pkt, JUMP))
    assert len(list(r.frames())) == 2         # consume; base stays ~JUMP
    post = _stream(2, seed=15)
    pkts = packetize(post, PAYLOAD)           # the card restarts at 0
    assert r.feed(pkts[0]) == 0               # first sighting: held back
    for pkt in pkts[1:]:                      # second agrees -> resync back
        assert r.feed(pkt) > 0
    got = _drain(r)
    assert [i for i, _ in got] == [0, 1]
    want0 = post[:FRAME_SAMPLES].copy()
    want0[:PAYLOAD // 2] = 0
    np.testing.assert_array_equal(got[0][1], want0)
    np.testing.assert_array_equal(got[1][1], post[FRAME_SAMPLES:])
    assert r.stats()["resyncs"] == 2          # one forward + the backward one


def test_read_frame_indexed_gaps_mark_drops(engine):
    stream = _stream(5, seed=12)
    r = PacketReassembler(FRAME_SAMPLES, ring_frames=2, native=engine)
    for pkt in packetize(stream, PAYLOAD):
        r.feed(pkt)
    got = _drain(r)
    assert [i for i, _ in got] == [3, 4]      # frames 0-2 dropped (ring=2)
    np.testing.assert_array_equal(got[0][1],
                                  stream[3 * FRAME_SAMPLES:4 * FRAME_SAMPLES])


def _engines():
    """The port's two engines and the JAX package's two, on one geometry
    (ring of 3 frames)."""
    out = {}
    for name, mod in (("port", capture), ("jax", jax_capture)):
        for native in (False, True):
            r = mod.PacketReassembler(FRAME_SAMPLES, ring_frames=3,
                                      native=native)
            assert r.is_native == native
            out[f"{name}-{'native' if native else 'numpy'}"] = r
    return out


def _schedule(seed, frames=40):
    """A seeded adversarial schedule: ("feed", datagram) and ("read",)
    ops mixing in-order packets with drops, duplicates, swaps, stale
    re-sends, malformed datagrams, corrupted far offsets, a genuine forward
    jump of 1000 frames at a third of the stream and a capture-card restart
    (offsets and sequence numbers back to the start) at two thirds, and
    reads of one frame at a time between packets."""
    rng = np.random.default_rng(seed)
    pkts = packetize(_stream(frames, seed=100 + seed), PAYLOAD)
    n = len(pkts)
    ops, sent, kinds = [], [], set()
    off_shift, seq_shift, i = 0, 0, 0
    while i < n:
        if i == n // 3 and "jump" not in kinds:
            off_shift, kinds = off_shift + JUMP, kinds | {"jump"}
        if i == 2 * n // 3 and "restart" not in kinds:
            # the restarted card counts from 0 again: this packet lands at
            # offset 0 with sequence number 1
            off_shift = -int.from_bytes(pkts[i][4:10], "little")
            seq_shift, kinds = -i, kinds | {"restart"}

        def at(k):
            return _moved(pkts[k], off_shift, k + 1 + seq_shift)

        r = rng.random()
        if r < 0.06:
            kinds.add("drop")
            i += 1
            continue
        if r < 0.12:
            kinds.add("duplicate")
            ops += [("feed", at(i))] * 2
        elif r < 0.18 and i + 1 < n:
            kinds.add("swap")
            ops += [("feed", at(i + 1)), ("feed", at(i))]
            i += 1
        elif r < 0.23 and sent:
            kinds.add("stale")
            ops += [("feed", sent[rng.integers(len(sent))]),
                    ("feed", at(i))]
        elif r < 0.26:
            kinds.add("malformed")
            ops += [("feed", bytes(rng.integers(0, 256, rng.integers(0, 10),
                                                dtype=np.uint8))),
                    ("feed", at(i))]
        elif r < 0.30:
            kinds.add("corrupted")
            ops += [("feed", pkts[i][:4] + int(rng.integers(1 << 38, 1 << 47))
                     .to_bytes(6, "little") + b"\xff" * 32)] * \
                int(rng.integers(1, 3)) + [("feed", at(i))]
        else:
            ops.append(("feed", at(i)))
        sent.append(ops[-1][1])
        i += 1
        if rng.random() < 0.2:
            ops.append(("read",))
    return ops, kinds


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_engines_equal_jax_engines_on_adversarial_schedules(seed):
    """After every op of the schedule the four engines return the same
    feed result, the same (index, frame) or None, and the same stats()."""
    ops, kinds = _schedule(seed)
    assert kinds >= {"jump", "restart", "drop", "duplicate", "swap",
                     "stale", "corrupted"}
    engines = _engines()
    names = list(engines)
    frames_seen = 0
    for k, op in enumerate(ops):
        if op[0] == "feed":
            got = [engines[n].feed(op[1]) for n in names]
            assert len(set(got)) == 1, (k, dict(zip(names, got)))
        else:
            got = [engines[n].read_frame_indexed() for n in names]
            if got[0] is None:
                assert all(g is None for g in got), k
            else:
                frames_seen += 1
                for g in got[1:]:
                    assert g[0] == got[0][0], k
                    np.testing.assert_array_equal(g[1], got[0][1])
        stats = [engines[n].stats() for n in names]
        assert all(s == stats[0] for s in stats), (k, dict(zip(names, stats)))
    tails = [_drain(engines[n]) for n in names]
    for t in tails[1:]:
        assert [i for i, _ in t] == [i for i, _ in tails[0]]
        for (_, a), (_, b) in zip(t, tails[0]):
            np.testing.assert_array_equal(a, b)
    s = stats[0]
    # every stat moved: the schedule reached every branch of the engines
    assert frames_seen + len(tails[0]) > 0
    assert min(s.values()) > 0, s
    assert s["resyncs"] >= 2, s                 # forward and backward


def test_backward_resync_keeps_last_seq_quirk(engine):
    """After a restart's backward resync the highest sequence number seen
    is kept (native/dca1000.cc does not reset it), so every post-restart
    packet counts as reordered; the JAX package's engine counts the same."""
    pre, post = _stream(2, seed=20), _stream(2, seed=21)
    ours = PacketReassembler(FRAME_SAMPLES, native=engine)
    ref = jax_capture.PacketReassembler(FRAME_SAMPLES, native=engine)
    for r in (ours, ref):
        for pkt in packetize(pre, PAYLOAD, first_seq=50):
            r.feed(_moved(pkt, JUMP))
        list(r.frames())
        post_pkts = packetize(post, PAYLOAD, first_seq=1)
        before = r.stats()["reordered"]
        for pkt in post_pkts:
            r.feed(pkt)
        s = r.stats()
        assert s["resyncs"] == 2
        assert s["reordered"] - before == len(post_pkts)
    assert ours.stats() == ref.stats()


def test_rejected_far_behind_packet_counts_twice_quirk(engine):
    """A far-behind first sighting is rejected as a resync candidate and
    its payload also counts as late bytes; a far-ahead one counts only as
    rejected. Both as in the JAX package's engine."""
    stream = _stream(2, seed=22)
    ours = PacketReassembler(FRAME_SAMPLES, native=engine)
    ref = jax_capture.PacketReassembler(FRAME_SAMPLES, native=engine)
    for r in (ours, ref):
        for pkt in packetize(stream, PAYLOAD):
            r.feed(_moved(pkt, JUMP))
        list(r.frames())
        behind = packetize(_stream(1, seed=23), PAYLOAD)[0]
        s0 = r.stats()
        assert r.feed(behind) == 0
        s1 = r.stats()
        assert s1["rejected"] - s0["rejected"] == 1
        assert s1["late_bytes"] - s0["late_bytes"] == PAYLOAD
        ahead = _moved(behind, 3 * JUMP)
        assert r.feed(ahead) == 0
        s2 = r.stats()
        assert s2["rejected"] - s1["rejected"] == 1
        assert s2["late_bytes"] == s1["late_bytes"]
    assert ours.stats() == ref.stats()


@pytest.mark.parametrize("adc,chirps", [(32, 5), (256, 192)])
def test_stream_to_iq_planes_equals_jax(adc, chirps):
    rp = RadarParams(num_adc_samples=adc, num_chirp=chirps)
    jrp = JaxRadarParams(num_adc_samples=adc, num_chirp=chirps)
    samples = rp.num_rx * rp.num_chirp * rp.num_adc_samples * 2
    frame = np.random.default_rng(9).integers(
        -32768, 32768, samples).astype(np.int16)
    got = capture.stream_to_iq_planes(frame, rp)
    want = jax_capture.stream_to_iq_planes(frame, jrp)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int16
        assert g.shape == w.shape == (4, chirps, adc)
        assert g.flags.c_contiguous
        np.testing.assert_array_equal(g, w)


def test_packetize_equals_jax():
    stream = _stream(3, seed=24)
    for payload, first in ((PAYLOAD, 1), (DEFAULT_PAYLOAD, 7)):
        assert packetize(stream, payload, first) == \
            jax_capture.packetize(stream, payload, first)


def test_udp_capture_source_loopback(engine):
    """Real sockets on loopback: sender -> UDPCaptureSource.frames_indexed,
    every wait bounded by its timeout."""
    stream = _stream(3, seed=8)
    with UDPCaptureSource(FRAME_SAMPLES, port=0, host="127.0.0.1",
                          native=engine) as src:
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            for pkt in packetize(stream, DEFAULT_PAYLOAD):
                tx.sendto(pkt, ("127.0.0.1", src.port))
            got = list(src.frames_indexed(n=3, timeout=10.0))
        finally:
            tx.close()
        with pytest.raises(TimeoutError):
            next(src.frames(n=1, timeout=0.2))
    assert [i for i, _ in got] == [0, 1, 2]
    np.testing.assert_array_equal(np.concatenate([f for _, f in got]),
                                  stream)
