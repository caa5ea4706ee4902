"""Video inference dataset (port of human_pose_tpu/data/video.py; cv2
imported where it is used).

Counterpart of reference src/base/datasets/video.py: frame loop with optional
pause/seek keybinds, per-frame latency overlay, cv2.VideoWriter output. The
interactive display is auto-disabled in headless environments (the reference
assumes a desktop session).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable

import numpy as np

from ..loggers.pylogger import log
from ..utils.image import put_txt

CODECS = {".mp4": "mp4v", ".avi": "XVID", ".mov": "mp4v", ".mkv": "XVID"}


@dataclass
class VideoProcessingResult:
    speed_ms: float
    model_input_shape: tuple | None
    out_frame: np.ndarray


class InferenceVideoDataset:
    def __init__(
        self,
        filepath: str,
        out_filepath: str | None = None,
        start_frame: int = 0,
        display: bool | None = None,
    ):
        self.filepath = filepath
        self.out_filepath = out_filepath
        import cv2

        self.cap = cv2.VideoCapture(filepath)
        if not self.cap.isOpened():
            raise FileNotFoundError(f"cannot open video {filepath}")
        self.fps = self.cap.get(cv2.CAP_PROP_FPS) or 25.0
        self.num_frames = int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT))
        if start_frame:
            self.cap.set(cv2.CAP_PROP_POS_FRAMES, start_frame)
        self.writer: cv2.VideoWriter | None = None
        self.display = display if display is not None else bool(os.environ.get("DISPLAY"))
        self.paused = False

    def _ensure_writer(self, frame: np.ndarray) -> None:
        if self.writer is None and self.out_filepath:
            import cv2

            ext = os.path.splitext(self.out_filepath)[1]
            fourcc = cv2.VideoWriter_fourcc(*CODECS.get(ext, "mp4v"))
            os.makedirs(os.path.dirname(self.out_filepath) or ".", exist_ok=True)
            self.writer = cv2.VideoWriter(
                self.out_filepath, fourcc, self.fps, (frame.shape[1], frame.shape[0])
            )

    def _handle_keys(self) -> bool:
        """Returns False to stop. Keybinds: space pause, q/esc quit,
        a/d seek +-1s while paused (reference video.py:142-166)."""
        if not self.display:
            return True
        import cv2

        key = cv2.waitKey(1 if not self.paused else 50) & 0xFF
        if key in (ord("q"), 27):
            return False
        if key == ord(" "):
            self.paused = not self.paused
        if self.paused and key in (ord("a"), ord("d")):
            pos = self.cap.get(cv2.CAP_PROP_POS_FRAMES)
            delta = self.fps if key == ord("d") else -self.fps
            self.cap.set(cv2.CAP_PROP_POS_FRAMES, max(0, pos + delta))
            self.paused = False
        return True

    def run(self, callback: Callable[[np.ndarray], VideoProcessingResult]) -> None:
        import cv2

        idx = 0
        while True:
            if self.paused and self.display:
                if not self._handle_keys():
                    break
                continue
            ok, frame_bgr = self.cap.read()
            if not ok:
                break
            frame = cv2.cvtColor(frame_bgr, cv2.COLOR_BGR2RGB)
            result = callback(frame)
            out = result.out_frame
            put_txt(
                out,
                [
                    f"frame {idx}/{self.num_frames}",
                    f"input: {result.model_input_shape}",
                    f"latency: {result.speed_ms:.1f} ms",
                ],
            )
            out_bgr = cv2.cvtColor(out, cv2.COLOR_RGB2BGR)
            self._ensure_writer(out_bgr)
            if self.writer is not None:
                self.writer.write(out_bgr)
            if self.display:
                cv2.imshow("inference", out_bgr)
                if not self._handle_keys():
                    break
            idx += 1
        self.release()

    def release(self) -> None:
        self.cap.release()
        if self.writer is not None:
            self.writer.release()
            self.writer = None
        if self.display:
            import cv2

            try:
                cv2.destroyAllWindows()
            except Exception:
                pass
        log.info(f"processed video {self.filepath}")
