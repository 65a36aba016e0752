"""2D GUI: frame display window + interactive keyboard control.

Rebuild of the reference Gui/FrameDisplayer pair (src/openpose/gui/gui.cpp:
30-190 key handling, src/openpose/gui/frameDisplayer.cpp window management).
The key-state machine is pure (testable headless); FrameDisplayer owns the
OpenCV window.  Key map (lower-cased, as the reference):

  esc / q   quit                       space     pause
  h         print help                 m         fake-pause (frame-step seek)
  f         fullscreen toggle          l / k     seek +30 / -30 frames
  b         blend skeleton on frame    , / .     cycle rendered element
  1         skeletons                  2         all-part heatmap
  4         PAF field                  5..9, 0   single-part heatmaps 1..6
  z / x     toggle face / hand         - / =     NMS threshold -/+ 0.005
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

HELP_TEXT = """openpose_tpu_torch GUI commands:
  esc/q quit | space pause | m frame-step mode | l/k seek | f fullscreen
  b blend | ,/. cycle element | 1 skeleton | 2 heatmaps | 4 PAFs
  5..9,0 single-part heatmaps | z toggle face | x toggle hand
  -/= NMS threshold down/up"""

# part_to_show codes (openpose_tpu_torch.cli --part_to_show):
#   0 = skeletons, -1 = all-part heatmap, -2 = PAF field, n>0 = part n
_ELEMENT_CYCLE = (0, -1, -2)


@dataclasses.dataclass
class GuiState:
    running: bool = True
    paused: bool = False
    frame_step_mode: bool = False       # 'm': l/k move one frame at a time
    fullscreen: bool = False
    blend: bool = True
    part_to_show: int = 0
    seek_delta: int = 0                 # producer consumes and resets
    face_enabled: bool = True
    hand_enabled: bool = True
    nms_threshold_delta: float = 0.0    # accumulated -/+ adjustments
    show_help: bool = False


def handle_key(state: GuiState, key: int) -> GuiState:
    """Apply one key press (cv2.waitKey code; -1 = none) to the GUI state."""
    if key == -1:
        return state
    c = chr(key & 0xFF).lower()
    state.show_help = False
    if key == 27 or c == "q":
        state.running = False
        state.paused = False
    elif c == "h":
        state.show_help = True
    elif c == "f":
        state.fullscreen = not state.fullscreen
    elif c == " ":
        state.paused = not state.paused
    elif c == "m":
        state.frame_step_mode = not state.frame_step_mode
    elif c in ("l", "k"):
        if state.frame_step_mode:
            state.seek_delta += 1 if c == "l" else -1
        else:
            state.seek_delta += 30 if c == "l" else -60
    elif c == "b":
        state.blend = not state.blend
    elif c in (",", "."):
        idx = (_ELEMENT_CYCLE.index(state.part_to_show)
               if state.part_to_show in _ELEMENT_CYCLE else 0)
        idx = (idx + (1 if c == "." else -1)) % len(_ELEMENT_CYCLE)
        state.part_to_show = _ELEMENT_CYCLE[idx]
    elif c == "1":
        state.part_to_show = 0
    elif c == "2":
        state.part_to_show = -1
    elif c == "4":
        state.part_to_show = -2
    elif c in "567890":
        state.part_to_show = "567890".index(c) + 1
    elif c == "z":
        state.face_enabled = not state.face_enabled
    elif c == "x":
        state.hand_enabled = not state.hand_enabled
    elif c in ("-", "="):
        state.nms_threshold_delta += 0.005 * (-1 if c == "-" else 1)
    return state


class FrameDisplayer:
    """OpenCV window wrapper (frameDisplayer.cpp): named window, fullscreen
    switching, displayFrame with key polling."""

    def __init__(self, window_name: str = "openpose_tpu_torch",
                 fullscreen: bool = False):
        self.window_name = window_name
        self.fullscreen = fullscreen
        self._created = False

    def _ensure_window(self) -> None:
        import cv2
        if not self._created:
            cv2.namedWindow(self.window_name, cv2.WINDOW_NORMAL)
            self._created = True
        mode = (cv2.WINDOW_FULLSCREEN if self.fullscreen
                else cv2.WINDOW_NORMAL)
        cv2.setWindowProperty(self.window_name, cv2.WND_PROP_FULLSCREEN, mode)

    def switch_fullscreen(self) -> None:
        self.fullscreen = not self.fullscreen
        self._ensure_window()

    def display(self, frame: np.ndarray, wait_ms: int = 1) -> int:
        """Show one BGR frame; returns the cv2.waitKey code (-1 = none)."""
        import cv2
        self._ensure_window()
        cv2.imshow(self.window_name, frame)
        return cv2.waitKey(wait_ms)

    def close(self) -> None:
        import cv2
        if self._created:
            cv2.destroyWindow(self.window_name)
            self._created = False


class Gui:
    """Display + key handling + pause loop, for the CLI display mode."""

    def __init__(self, window_name: str = "openpose_tpu_torch"):
        self.displayer = FrameDisplayer(window_name)
        self.state = GuiState()

    def update(self, frame: np.ndarray) -> GuiState:
        """Show the frame, process keys; blocks while paused."""
        key = self.displayer.display(frame)
        want_fs = self.state.fullscreen
        self.state = handle_key(self.state, key)
        if self.state.show_help:
            print(HELP_TEXT)
        if self.state.fullscreen != want_fs:
            self.displayer.switch_fullscreen()
        while self.state.paused and self.state.running \
                and self.state.seek_delta == 0:
            key = self.displayer.display(frame, wait_ms=50)
            self.state = handle_key(self.state, key)
        return self.state

    def close(self) -> None:
        self.displayer.close()
