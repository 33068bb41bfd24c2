"""Live serving: DCA1000 UDP capture -> reassembly -> streaming pose
(counterpart of the repo's scripts/live_serve.py).

The full live topology the reference cannot express (it only post-processes
completed capture files):

    DCA1000 hori data port ─┐
                            ├─> PacketReassembler (C++ ring, zero-fill)
    DCA1000 vert data port ─┘        │ int16 I/Q planes (half-width wire)
                                     v
                    StreamingPoseEstimator (DSP + MNet + pose on the card,
                                            a CUDA graph a frame)

    # against real capture hardware (one UDP port per radar view):
    python -m hupr_tpu_torch.scripts.live_serve --hori-port 4098 \\
        --vert-port 4099 --frames 100

    # self-contained demo: a replay thread streams synthetic (or .bin)
    # captures over loopback sockets, packetized exactly like the card
    python -m hupr_tpu_torch.scripts.live_serve --synthetic --frames 32
    python -m hupr_tpu_torch.scripts.live_serve --replay path/to/single_1 \\
        --frames 64

Runs on the CUDA card, and fails without one; `--platform cpu` asks for the
CPU (and, as the JAX package's script does, serves MODEL.attention pallas
through the plain attention there). `--checkpoint` reads a `.pth`; without
one the weights are synthetic. Prints per-frame keypoints cadence,
end-to-end fps, and reassembly stats (drops / reorders / overflows).

Reading a YAML config needs PyYAML; `serve(args, cfg)` takes a config built
from the dataclasses instead, and returns the poses and the stats.
"""

from __future__ import annotations

import argparse
import copy
import os
import socket
import threading
import time

import numpy as np

from hupr_tpu_torch.config import load_config, resolve_config_path
from hupr_tpu_torch.data.capture import (DEFAULT_PAYLOAD, UDPCaptureSource,
                                         packetize, stream_to_iq_planes)
from hupr_tpu_torch.engine.checkpoint import load_checkpoint
from hupr_tpu_torch.engine.streaming import StreamingPoseEstimator
from hupr_tpu_torch.models.hupr import build_model
from hupr_tpu_torch.utils.device import resolve_device
from hupr_tpu_torch.utils.synthetic import synthetic_state_dict


def replay_thread(stream: np.ndarray, port: int, payload: int, fps: float):
    """Packetize an int16 capture stream and send it over loopback at
    roughly `fps` frames/s (the card's own pacing)."""
    def run():
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        # a brief sleep every burst keeps loopback from overrunning the
        # reader thread's socket buffer (a real card paces at `fps`)
        for i, pkt in enumerate(packetize(stream, payload)):
            tx.sendto(pkt, ("127.0.0.1", port))
            if i % 16 == 15:
                time.sleep(0.002)
        tx.close()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default="mscsa_prgcn_tpu.yaml")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--hori-port", type=int, default=0)
    ap.add_argument("--vert-port", type=int, default=0)
    ap.add_argument("--synthetic", action="store_true",
                    help="replay a synthetic capture over loopback")
    ap.add_argument("--replay", default=None,
                    help="replay {dir}/{hori,vert}/adc_data.bin over loopback")
    ap.add_argument("--ring-frames", type=int, default=16,
                    help="reassembler ring depth (frames buffered per view)")
    ap.add_argument("--platform", default=None,
                    help="cpu runs on the CPU (smoke runs); unset, the card")
    return ap


def platform_device(platform):
    """--platform: 'cpu' selects the CPU, unset the card (which raises
    without one); any other value is refused."""
    if platform not in (None, "cpu"):
        raise ValueError(f"--platform {platform!r}: the port runs on the "
                         f"card (unset) or on the CPU ('cpu')")
    return resolve_device(platform)


def serve(args, cfg, streams=None, native=None) -> dict:
    """The script's body on parsed `args` and a built `cfg`. `streams`
    ({'hori': int16, 'vert': int16} capture streams) are replayed over
    loopback in place of --synthetic / --replay. `native` goes to the
    reassemblers (data/capture.PacketReassembler). Returns the served
    frames' poses ('pred2d' (N, K, 2), 'maxvals' (N, K, 1)), the flushed
    ones, each view's reassembly stats, the resync count, the wall time,
    the fps and the mean process_frame time."""
    device = platform_device(args.platform)
    cfg = copy.deepcopy(cfg)
    if args.platform == "cpu" and \
            getattr(cfg.MODEL, "attention", "xla") == "pallas":
        # the JAX package's script takes the same turn: its kernels do not
        # lower on the CPU backend
        print("live_serve: cpu platform — MODEL.attention pallas -> xla")
        cfg.MODEL.attention = "xla"
    d = cfg.DATASET
    rp = d.radar_params()
    frame_samples = rp.num_rx * rp.num_chirp * rp.num_adc_samples * 2

    model = build_model(cfg, device)
    if args.checkpoint:
        load_checkpoint(args.checkpoint, model)
    else:
        print("live_serve: SYNTHETIC weights (no --checkpoint)")
        model.load_state_dict(synthetic_state_dict(model))

    est = StreamingPoseEstimator(model, None, params=rp,
                                 group=d.numGroupFrames,
                                 num_frames=d.numFrames, device=device)

    # build the kernels, plan the FFTs and capture the step's CUDA graph
    # BEFORE any packet arrives: while a first frame takes seconds the
    # capture keeps streaming, and a replay would overrun the ring
    print("live_serve: warming up (first_step + the graph step)...",
          flush=True)
    zero = (np.zeros((rp.num_rx, rp.num_chirp, rp.num_adc_samples),
                     np.int16),) * 2
    for _ in range(2):
        est.process_frame(zero, zero)
    est.reset()

    if streams is None and args.replay:
        streams = {v: np.fromfile(
            os.path.join(args.replay, v, "adc_data.bin"), np.int16,
            count=args.frames * frame_samples) for v in ("hori", "vert")}
    elif streams is None and args.synthetic:
        rng = np.random.default_rng(0)
        streams = {v: rng.integers(
            -300, 300, args.frames * frame_samples).astype(np.int16)
            for v in ("hori", "vert")}
    replaying = streams is not None
    # a replay pushes all frames immediately; size the ring to hold them
    ring = max(args.ring_frames, args.frames + 2) if replaying \
        else args.ring_frames
    host = "127.0.0.1" if replaying else "0.0.0.0"
    preds, maxvals, frame_s = [], [], []
    resyncs = 0
    with UDPCaptureSource(frame_samples, port=args.hori_port, host=host,
                          ring_frames=ring, native=native) as hori_src, \
         UDPCaptureSource(frame_samples, port=args.vert_port, host=host,
                          ring_frames=ring, native=native) as vert_src:

        if replaying:
            replay_thread(streams["hori"], hori_src.port, DEFAULT_PAYLOAD, 10)
            replay_thread(streams["vert"], vert_src.port, DEFAULT_PAYLOAD, 10)

        print(f"listening: hori={hori_src.port} vert={vert_src.port}, "
              f"{frame_samples} int16/frame, serving {args.frames} frames")
        t0 = time.perf_counter()
        n = 0
        # pair the two views by ABSOLUTE stream frame index, not arrival
        # order: an asymmetric drop (ring overflow on one port) would
        # otherwise silently shift every subsequent pose by a frame
        hori_it = hori_src.frames_indexed(2 * args.frames, timeout=30.0)
        vert_it = vert_src.frames_indexed(2 * args.frames, timeout=30.0)
        try:
            while n < args.frames:
                hidx, hf = next(hori_it)
                vidx, vf = next(vert_it)
                while hidx != vidx:
                    print(f"resync: hori@{hidx} vert@{vidx} — skipping the "
                          "older view frame")
                    resyncs += 1
                    if hidx < vidx:
                        hidx, hf = next(hori_it)
                    else:
                        vidx, vf = next(vert_it)
                t1 = time.perf_counter()
                pred, maxv = est.process_frame(stream_to_iq_planes(hf, rp),
                                               stream_to_iq_planes(vf, rp))
                frame_s.append(time.perf_counter() - t1)
                preds.append(pred)
                maxvals.append(maxv)
                n += 1
                if n in (1, args.frames) or n % 16 == 0:
                    print(f"frame {n:4d} (stream idx {hidx}): "
                          f"keypoint[0]={np.asarray(pred)[0]}, "
                          f"max={float(np.asarray(maxv).max()):.4f}")
        except (StopIteration, TimeoutError) as exc:
            print(f"capture ended early after {n} aligned frames: "
                  f"{type(exc).__name__} {exc}")
        flushed = est.flush()   # drain the end-of-sequence lookahead poses
        dt = time.perf_counter() - t0
        print(f"served {n} frames in {dt:.2f}s = {n / dt:.1f} fps "
              f"(includes capture wait + device round-trips)")
        stats = {"hori": hori_src.reassembler.stats(),
                 "vert": vert_src.reassembler.stats()}
        print(f"hori stats: {stats['hori']}")
        print(f"vert stats: {stats['vert']}")
        engines_native = (hori_src.reassembler.is_native
                          and vert_src.reassembler.is_native)
    k = d.numKeypoints
    return {"pred2d": np.stack(preds) if preds else np.zeros((0, k, 2)),
            "maxvals": np.stack(maxvals) if maxvals else np.zeros((0, k, 1)),
            "flushed": flushed, "served": n, "seconds": dt,
            "fps": n / dt, "resyncs": resyncs, "stats": stats,
            "native": engines_native,
            "process_frame_ms": 1e3 * float(np.mean(frame_s))
            if frame_s else None}


def main(argv=None) -> dict:
    args = build_arg_parser().parse_args(argv)
    platform_device(args.platform)      # refused before any file is read
    cfg = load_config(resolve_config_path(args.config))
    return serve(args, cfg)


if __name__ == "__main__":
    main()
