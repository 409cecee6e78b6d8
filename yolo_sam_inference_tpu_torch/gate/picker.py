"""The cv2 click-two-lines ROI picker on the port.

A copy of the JAX package's ``gate/picker.py`` (which the port may not
import). A cv2 window per condition: the operator clicks two X positions
(vertical green lines preview the gate), presses ``r`` to reset or ``c`` to
confirm, and the pair becomes that condition's ``{x_min, x_max}``. On a
host without a display it raises, naming the non-interactive equivalents
(``--roi`` / ``--roi-file``) and the browser picker (``web/app.py``).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Tuple

_TITLE = (
    "Select ROI - Click two points for min and max X coordinates "
    "(Press 'r' to reset, 'c' to confirm)"
)


class _XLinePicker:
    """Collects up to two clicked X positions on a cv2 window."""

    def __init__(self, cv2_mod, frame):
        self._cv2 = cv2_mod
        self._frame = frame
        self.xs: List[int] = []

    def on_mouse(self, event, x, _y, _flags, _param) -> None:
        if event != self._cv2.EVENT_LBUTTONDOWN or len(self.xs) >= 2:
            return
        self.xs.append(int(x))
        self._redraw()

    def reset(self) -> None:
        self.xs.clear()
        self._cv2.imshow(_TITLE, self._frame)

    def _redraw(self) -> None:
        preview = self._frame.copy()
        height = self._frame.shape[0]
        for x in self.xs:
            self._cv2.line(preview, (x, 0), (x, height), (0, 255, 0), 2)
        self._cv2.imshow(_TITLE, preview)

    def run(self) -> Tuple[int, int]:
        self._cv2.imshow(_TITLE, self._frame)
        while True:
            key = self._cv2.waitKey(1) & 0xFF
            if key == ord("r"):
                self.reset()
            elif key == ord("c") and len(self.xs) == 2:
                self._cv2.destroyAllWindows()
                return min(self.xs), max(self.xs)
            elif not self.xs:
                # nothing selected yet: keep the clean frame on screen
                self._cv2.imshow(_TITLE, self._frame)


def get_roi_coordinates(image_path: Path) -> Tuple[int, int]:
    """Open a cv2 window and return the clicked ``(x_min, x_max)`` pair:
    a left click adds a vertical line (two at most), ``r`` resets, ``c``
    confirms once two points exist."""
    try:
        import cv2
    except ImportError as e:  # pragma: no cover - environment-dependent
        raise RuntimeError(
            "interactive ROI picking needs cv2; use --roi/--roi-file or "
            "the web picker (yolo_sam_inference_tpu_torch.web.app) instead"
        ) from e

    frame = cv2.imread(str(image_path))
    if frame is None:
        raise ValueError(f"Could not read image: {image_path}")
    try:
        cv2.namedWindow(_TITLE)
    except cv2.error as e:  # pragma: no cover - headless host
        raise RuntimeError(
            "no display available for the interactive ROI picker; use "
            "--roi/--roi-file or the web picker (web/app.py) instead"
        ) from e
    picker = _XLinePicker(cv2, frame)
    cv2.setMouseCallback(_TITLE, picker.on_mouse)
    return picker.run()
