"""Command line of the port: `python -m gifgan_tpu_torch <command>`.

One command so far, `track`, with the flags of the JAX package's
`python -m gifgan_tpu track` (gifgan_tpu/cli.py) plus `--device`: it runs on
the CUDA card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import sys


def cmd_track(args) -> None:
    from gifgan_tpu_torch.core.config import TrackConfig
    from gifgan_tpu_torch.track.pipeline import run_directory

    cfg = TrackConfig(min_jaccard=args.min_jaccard, max_skip=args.max_skip,
                      min_frame_count=args.min_frame_count,
                      min_total_detections=args.min_total_detections,
                      target_size=args.target_size,
                      flow_backend=args.flow_backend,
                      detector_backend=args.detector_backend)
    stats = run_directory(args.input_directory, args.output_directory, cfg,
                          cascade_path=args.cascade,
                          max_consecutive_errors=args.max_consecutive_errors,
                          workers=args.workers,
                          detect_batch_clips=args.detect_batch,
                          device=args.device)
    print(stats.render_text())


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="gifgan_tpu_torch")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("track", help="face-track preprocessing over a dir")
    p.add_argument("--input-directory", required=True)
    p.add_argument("--output-directory", required=True)
    p.add_argument("--min-jaccard", type=float, default=0.60)
    p.add_argument("--max-skip", type=int, default=6)
    p.add_argument("--min-frame-count", type=int, default=20)
    p.add_argument("--min-total-detections", type=int, default=10)
    p.add_argument("--target-size", type=int, default=256)
    p.add_argument("--max-consecutive-errors", type=int, default=10)
    p.add_argument("--cascade", default=None,
                   help="path to an OpenCV Haar cascade XML")
    p.add_argument("--flow-backend", default="auto",
                   choices=["auto", "cv2", "mxu", "jax"],
                   help="stabilizer corner+LK backend (auto and mxu = the "
                        "device kernels, kernels/flow.py; cv2 = OpenCV on "
                        "the host; jax is not ported yet)")
    p.add_argument("--detector-backend", default="auto",
                   choices=["auto", "native", "device", "cv2", "python"],
                   help="Haar cascade backend (auto and device = the "
                        "pyramid-packed cascade on the card, "
                        "track/haar_device.py; the others run on the host)")
    p.add_argument("--workers", type=int, default=1,
                   help="thread-pool file concurrency (decode releases the "
                        "GIL)")
    p.add_argument("--detect-batch", type=int, default=1,
                   help="with the device detector: decode N files per group "
                        "and detect them in one dispatch (detect_clips)")
    p.add_argument("--device", default=None,
                   help="torch device of the device kernels (default: the "
                        "CUDA card; cpu runs their plain versions)")
    p.set_defaults(fn=cmd_track)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
