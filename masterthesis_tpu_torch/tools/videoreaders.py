"""Video readers and writers.

The port of ``masterthesis_tpu/tools/videoreaders.py``: ``FrameReader`` and
``FrameWriter`` (cv2, imported when one is made), and ``SVOReader`` (ZED
stereo ``.svo`` through the pyzed SDK, gated as in the JAX package: it
raises when pyzed is missing). Frames are RGB uint8 HWC. One difference:
``FrameWriter`` raises when cv2 cannot open its video writer (a codec the
build lacks), where the JAX package's would write nothing.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np


class FrameReader:
    """Sequential video frame reader."""

    def __init__(self, filepath: str):
        import cv2

        self._cv2 = cv2
        self.filepath = filepath
        self.cam = cv2.VideoCapture(filepath)
        if not self.cam.isOpened():
            raise RuntimeError(f"Could not open video file {filepath}")

    def __len__(self):
        return max(0, int(self.cam.get(self._cv2.CAP_PROP_FRAME_COUNT)))

    @property
    def fps(self) -> float:
        return float(self.cam.get(self._cv2.CAP_PROP_FPS))

    def get_frame(self) -> Optional[np.ndarray]:
        ok, frame = self.cam.read()
        if not ok:
            return None
        return self._cv2.cvtColor(frame, self._cv2.COLOR_BGR2RGB)

    def __iter__(self):
        while True:
            frame = self.get_frame()
            if frame is None:
                return
            yield frame

    def close(self):
        self.cam.release()


class FrameWriter:
    """Frames to a video (MJPG in ``fname`` under ``outdir``) or to PNG files."""

    def __init__(self, outdir: str, outfmt: str = "image", fname: str = "video.avi",
                 fps: float = 25.0, frame_size=None):
        import cv2

        self._cv2 = cv2
        self.outdir = outdir
        self.outfmt = outfmt
        self.fps = fps
        self.frame_size = frame_size
        self.writer = None
        self.fname = fname
        os.makedirs(outdir, exist_ok=True)

    def write(self, frame: np.ndarray, index: int = 0):
        bgr = self._cv2.cvtColor(np.asarray(frame, np.uint8), self._cv2.COLOR_RGB2BGR)
        if "image" in self.outfmt:
            self._cv2.imwrite(os.path.join(self.outdir, f"frame_{index:06d}.png"), bgr)
            return
        if self.writer is None:
            h, w = bgr.shape[:2]
            path = os.path.join(self.outdir, self.fname)
            fourcc = self._cv2.VideoWriter_fourcc(*"MJPG")
            self.writer = self._cv2.VideoWriter(path, fourcc, self.fps, (w, h))
            if not self.writer.isOpened():
                raise RuntimeError(f"cv2 could not open an MJPG video writer for {path}")
        self.writer.write(bgr)

    def close(self):
        if self.writer is not None:
            self.writer.release()


class SVOReader:
    """ZED stereo ``.svo`` reader. Needs the ZED ``pyzed`` SDK; without it
    the constructor raises."""

    def __init__(self, filepath: str, outdir: str = ".", outfmt: str = "image"):
        try:
            import pyzed.sl as sl
        except ImportError as e:
            raise ImportError(
                "SVOReader requires the ZED 'pyzed' SDK, which is not installed "
                "in this environment. Use FrameReader for standard video files."
            ) from e
        self._sl = sl
        self.filepath = filepath
        self.outdir = outdir
        self.outfmt = outfmt
        init = sl.InitParameters(svo_input_filename=filepath, svo_real_time_mode=False)
        self.zed = sl.Camera()
        status = self.zed.open(init)
        if status != sl.ERROR_CODE.SUCCESS:
            raise RuntimeError(f"Could not open SVO file: {status}")
        self.runtime = sl.RuntimeParameters()
        self.mat = sl.Mat()
        self.writer = FrameWriter(outdir, outfmt)

    def __len__(self):
        return self.zed.get_svo_number_of_frames()

    def get_frame(self) -> Optional[np.ndarray]:
        sl = self._sl
        if self.zed.grab(self.runtime) == sl.ERROR_CODE.SUCCESS:
            self.zed.retrieve_image(self.mat, sl.VIEW.LEFT)
            frame = self.mat.get_data()[:, :, :3][:, :, ::-1]  # BGRA -> RGB
            return np.ascontiguousarray(frame)
        return None

    def write(self, frame: np.ndarray, index: int = 0):
        if frame is not None:
            self.writer.write(frame, index)

    def close(self):
        self.zed.close()
        self.writer.close()
