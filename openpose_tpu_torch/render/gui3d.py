"""3-D skeleton viewer (Gui3D equivalent, headless-friendly).

The reference uses OpenGL/FreeGLUT (src/openpose/gui/gui3D.cpp, compiled
only WITH_3D_RENDERER).  Here: matplotlib 3-D rendering that works headless
(render to image / file) or interactively, which fits servers without a
display.  Counterpart of `openpose_tpu/render/gui3d.py`: a copy under the
port's package name.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from openpose_tpu_torch.params import PoseModel, POSE_MODEL_INFO


def render_skeleton_3d(keypoints_3d: np.ndarray, model: PoseModel,
                       score_threshold: float = 0.0,
                       elev: float = 15.0, azim: float = -70.0,
                       out_path: Optional[str] = None) -> np.ndarray:
    """keypoints_3d [people, parts, 4] (x, y, z, score) -> RGB image array.

    Saves to out_path when given; always returns the rendered RGB array.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    info = POSE_MODEL_INFO[model]
    fig = plt.figure(figsize=(6, 6), dpi=100)
    ax = fig.add_subplot(111, projection="3d")
    for person in range(keypoints_3d.shape[0]):
        kp = keypoints_3d[person]
        valid = kp[:, 3] > score_threshold
        pairs = info.render_pairs
        for i in range(0, len(pairs), 2):
            a, b = pairs[i], pairs[i + 1]
            if valid[a] and valid[b]:
                r, g, bl = info.colors[b % len(info.colors)]
                ax.plot([kp[a, 0], kp[b, 0]], [kp[a, 2], kp[b, 2]],
                        [-kp[a, 1], -kp[b, 1]],
                        color=(r / 255, g / 255, bl / 255), linewidth=2)
        if valid.any():
            ax.scatter(kp[valid, 0], kp[valid, 2], -kp[valid, 1], s=8)
    ax.view_init(elev=elev, azim=azim)
    ax.set_xlabel("x")
    ax.set_ylabel("z")
    ax.set_zlabel("-y")
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    if out_path:
        fig.savefig(out_path)
    plt.close(fig)
    return buf


class Gui3D:
    """Live 3-D skeleton viewer with mouse rotation (Gui3D equivalent).

    The reference's OpenGL/FreeGLUT viewer (src/openpose/gui/gui3D.cpp:
    1-540, WITH_3D_RENDERER) re-designed on matplotlib's interactive 3-D
    axes: `update(keypoints_3d)` redraws the current frame in place while
    the figure stays live — drag to rotate (matplotlib's built-in Axes3D
    mouse handling plays the mouseRotate/mouseButton role,
    gui3D.cpp:360-430), scroll/keys zoom.  Degrades to the headless
    `render_skeleton_3d` path when no display is available (`live=False`
    or matplotlib falls back to Agg)."""

    def __init__(self, model: PoseModel, score_threshold: float = 0.0,
                 live: bool = True):
        import matplotlib
        if not live:
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        self._plt = plt
        self.model = model
        self.info = POSE_MODEL_INFO[model]
        self.score_threshold = score_threshold
        self.live = live and matplotlib.get_backend().lower() != "agg"
        if self.live:
            plt.ion()
        self.fig = plt.figure(figsize=(6, 6), dpi=100)
        self.ax = self.fig.add_subplot(111, projection="3d")
        self.ax.view_init(elev=15.0, azim=-70.0)

    def update(self, keypoints_3d: Optional[np.ndarray]) -> None:
        """Redraw with this frame's [people, parts, 4] keypoints; preserves
        the user's current rotation between frames."""
        elev, azim = self.ax.elev, self.ax.azim
        self.ax.cla()
        info = self.info
        if keypoints_3d is not None and keypoints_3d.size:
            for person in range(keypoints_3d.shape[0]):
                kp = keypoints_3d[person]
                valid = kp[:, 3] > self.score_threshold
                pairs = info.render_pairs
                for i in range(0, len(pairs), 2):
                    a, b = pairs[i], pairs[i + 1]
                    if valid[a] and valid[b]:
                        r, g, bl = info.colors[b % len(info.colors)]
                        self.ax.plot(
                            [kp[a, 0], kp[b, 0]], [kp[a, 2], kp[b, 2]],
                            [-kp[a, 1], -kp[b, 1]],
                            color=(r / 255, g / 255, bl / 255), linewidth=2)
                if valid.any():
                    self.ax.scatter(kp[valid, 0], kp[valid, 2],
                                    -kp[valid, 1], s=8)
        self.ax.view_init(elev=elev, azim=azim)
        if self.live:
            self.fig.canvas.draw_idle()
            self.fig.canvas.flush_events()
            self._plt.pause(0.001)
        else:
            self.fig.canvas.draw()

    def frame(self) -> np.ndarray:
        """Current canvas as an RGB array (for saving/testing)."""
        self.fig.canvas.draw()
        return np.asarray(self.fig.canvas.buffer_rgba())[..., :3].copy()

    def close(self) -> None:
        self._plt.close(self.fig)
