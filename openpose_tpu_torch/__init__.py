"""openpose_tpu_torch: the body pose path (single- and multi-scale), the
whole-body face and hand cascade, and the `Wrapper` entry point with
top-down refinement, LK tracking and the batched video runner in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A second package beside the JAX reference `openpose_tpu`.  It follows that
package's module layout and tensor layouts (NHWC net outputs and heatmaps,
peaks `[N, C, K+1, 3]`, pair scores `[N, P, K, K]`) so each module can be
tested against its JAX counterpart.  It imports nothing of `openpose_tpu`
and nothing of JAX: the host modules it needs (`params.py`,
`models/caffe_proto.py`, `models/specs/`, `pose/scaler.py`,
`ops/assembly.py`, `io/json_io.py`, `face/detector.py`, `hand/detector.py`,
`face/haar.py`, `render/render.py`, `runtime/pipeline.py`,
`io/native_loader.py`, `utils/native_build.py`, `utils/logging.py`) are its
own copies at the same relative paths.  Only `render/render.py` needs
OpenCV, and only `Wrapper.render` imports it.

Its entry points run on the card: given no `device` they ask for `"cuda"`
and raise where there is none (`device.py`); pass `device="cpu"` for the
CPU.  Importing the package compiles nothing: the CUDA kernels are built
from `kernels/*.cu` on their first launch (`kernels/build.py`).  On CPU
tensors every kernel wrapper runs its plain PyTorch version instead.
"""

__version__ = "0.1.0"
