"""Dataset-prep CLI: dump frames from videos (or ZED .svo recordings).

The port of ``masterthesis_tpu/tools/extract.py``, on the port's
``tools/videoreaders.py``. It covers the capability of the reference's two
extraction scripts (src/misc/extract_image.py, extract_svo_image.py) in one
tool: readers are picked per file by extension, any mix of files
and directories can be passed, and frames can be subsampled by stride or
capped by count.

Examples:
    python -m masterthesis_tpu_torch.tools.extract clip.mp4 -o frames/
    python -m masterthesis_tpu_torch.tools.extract recordings/ -o frames/ \
        --stride 30 --limit 500 --per-video-dirs
    python -m masterthesis_tpu_torch.tools.extract drive.svo -o frames/  # needs pyzed
"""
from __future__ import annotations

import argparse
import os
from typing import Iterator, List

from masterthesis_tpu_torch.tools.videoreaders import FrameReader, FrameWriter, SVOReader

VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".webm", ".svo")


def collect_videos(paths: List[str]) -> List[str]:
    """Expand files/directories into a flat, sorted list of video paths."""
    videos = []
    for path in paths:
        if os.path.isdir(path):
            for name in sorted(os.listdir(path)):
                if name.lower().endswith(VIDEO_EXTS):
                    videos.append(os.path.join(path, name))
        elif os.path.isfile(path):
            videos.append(path)
        else:
            raise FileNotFoundError(path)
    if not videos:
        raise ValueError(f"no video files found under {paths}")
    return videos


def iter_frames(path: str) -> Iterator:
    """Yield RGB frames using the reader that matches the container."""
    if path.lower().endswith(".svo"):
        reader = SVOReader(path)
        try:
            while True:
                frame = reader.get_frame()
                if frame is None:
                    return
                yield frame
        finally:
            reader.close()
    else:
        reader = FrameReader(path)
        try:
            yield from reader
        finally:
            reader.close()


def extract_video(path: str, outdir: str, stride: int = 1, limit: int | None = None,
                  out_fmt: str = "image") -> int:
    """Write every ``stride``-th frame of one video; returns frames written."""
    writer = FrameWriter(outdir, out_fmt)
    written = 0
    try:
        for i, frame in enumerate(iter_frames(path)):
            if i % stride:
                continue
            writer.write(frame, i)
            written += 1
            if limit is not None and written >= limit:
                break
    finally:
        writer.close()
    return written


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        "extract", description="dump frames from videos / .svo recordings"
    )
    p.add_argument("inputs", nargs="+", help="video files and/or directories of videos")
    p.add_argument("-o", "--outdir", default="frames", help="output directory")
    p.add_argument("--stride", type=int, default=10, help="keep every Nth frame")
    p.add_argument("--limit", type=int, default=None, help="max frames per video")
    p.add_argument("--out-fmt", default="image", choices=["image", "video"],
                   help="write pngs or re-encode a subsampled video")
    p.add_argument("--per-video-dirs", action="store_true",
                   help="write each video's frames into outdir/<video-stem>/")
    args = p.parse_args(argv)
    total = 0
    for video in collect_videos(args.inputs):
        dest = args.outdir
        if args.per_video_dirs:
            dest = os.path.join(dest, os.path.splitext(os.path.basename(video))[0])
        n = extract_video(video, dest, args.stride, args.limit, args.out_fmt)
        total += n
        print(f"{video}: {n} frame(s) -> {dest}")
    print(f"done: {total} frame(s) total")


if __name__ == "__main__":
    main()
