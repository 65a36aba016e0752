"""The epilogue of the CNN's bf16 convolutions (`kernels/conv_epilogue.cu`).

After each bf16 convolution `models/graph.py::PoseNet` adds the float32
bias, rounds the sum to bf16 once and applies the activation that the plan
(`graph.epilogue_plan`) folds into it: "none", "relu" or "prelu".

* `plain`: those steps as PyTorch operations, the arithmetic the kernel is
  held to bit for bit; `activate` is its activation, which also runs the
  activation layers that no convolution folds.
* `bias_act`: the hand-written kernel `conv_epilogue_kernel`, one pass over
  the NHWC output in place.  It replaces no TPU kernel: in the JAX package
  XLA fuses the bias and the activation into the convolution.

`fuses(x)` says where the kernel runs: on a bfloat16 CUDA tensor.
Elsewhere (a CPU tensor, or the float64 of a gradient check) `bias_act`
runs the plain version; on a bfloat16 CUDA tensor it launches the kernel
on the current stream, or raises; it never falls back.  Where autograd
records the step (a trainer's net), the kernel runs inside `_BiasAct`,
whose backward is the plain version's own backward written out in PyTorch
(the same operations on the same values), so that the gradients are
bit-equal too; for that a PReLU's kernel also keeps the pre-activation.
`bias_act.launches` counts the kernel launches.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from openpose_tpu_torch.kernels import build

# the kernel's codes of the activations
KINDS = {"none": 0, "relu": 1, "prelu": 2}


def activate(x: torch.Tensor, kind: str,
             slope: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ReLU (`F.relu`), PReLU with the float32 slope [C] rounded to x's
    dtype first, or nothing, on NCHW-indexed x."""
    if kind == "relu":
        return F.relu(x)
    if kind == "prelu":
        slope = slope.to(x.dtype)
        return torch.where(x >= 0, x, x * slope[:, None, None])
    if kind != "none":
        raise ValueError(f"activation must be one of {sorted(KINDS)}, "
                         f"got {kind!r}")
    return x


def plain(x: torch.Tensor, bias: torch.Tensor, kind: str,
          slope: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The float32 bias [C] added to x [N, C, H, W] in float32, the sum
    rounded to x's dtype, then `activate`."""
    return activate((x + bias[:, None, None]).to(x.dtype), kind, slope)


def fuses(x: torch.Tensor) -> bool:
    """Whether `bias_act` launches the kernel on x: a bfloat16 CUDA
    tensor."""
    return x.is_cuda and x.dtype == torch.bfloat16


def _check(x, bias, kind, slope) -> None:
    if kind not in KINDS:
        raise ValueError(f"activation must be one of {sorted(KINDS)}, "
                         f"got {kind!r}")
    if x.ndim != 4:
        raise ValueError(f"x must be an [N, C, H, W] tensor, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("x must be channels-last contiguous (NHWC memory)")
    c = x.shape[1]
    named = [("bias", bias)] + ([("slope", slope)] if kind == "prelu" else [])
    for name, t in named:
        if t is None or t.device != x.device or t.dtype != torch.float32 \
                or tuple(t.shape) != (c,) or not t.is_contiguous():
            got = None if t is None else (t.dtype, tuple(t.shape), t.device)
            raise ValueError(f"{name} must be a contiguous float32 [{c}] "
                             f"tensor on {x.device}, got {got}")


def _launch(x: torch.Tensor, bias: torch.Tensor, kind: str,
            slope: Optional[torch.Tensor],
            pre: Optional[torch.Tensor] = None) -> None:
    """The kernel over x in place; pre, for PReLU, receives the
    pre-activation."""
    c = x.shape[1]
    vec = next(v for v in (8, 4, 2, 1) if c % v == 0)
    lib = build.library()
    code = lib.conv_epilogue_launch(
        x.data_ptr(), bias.data_ptr(),
        slope.data_ptr() if kind == "prelu" else None,
        None if pre is None else pre.data_ptr(), x.numel() // c, c,
        KINDS[kind], vec, x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, code, "conv_epilogue_kernel launch")
    bias_act.launches += 1


class _BiasAct(torch.autograd.Function):
    """The kernel under autograd.  Writing over the convolution's output is
    safe: the convolution's backward reads its input and weight only.  The
    backward runs what autograd runs for `plain`: ReLU's
    `threshold_backward` on the output; PReLU's two `where` branches and
    the product's two gradients on the kept bf16 pre-activation, the
    slope's summed in bf16 and cast to float32; the float32 bias's gradient
    the float32 sum over N, H and W; x's the activation's, whose round trip
    through float32 changes no bit."""

    @staticmethod
    def forward(ctx, x, bias, slope, kind):
        pre = torch.empty_like(x) if kind == "prelu" else None
        _launch(x, bias, kind, slope, pre)
        ctx.mark_dirty(x)
        ctx.kind = kind
        if kind == "relu":
            ctx.save_for_backward(x)
        elif kind == "prelu":
            ctx.save_for_backward(pre, slope)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad_slope = None
        if ctx.kind == "relu":
            out, = ctx.saved_tensors
            grad = torch.ops.aten.threshold_backward(grad, out, 0)
        elif ctx.kind == "prelu":
            y, slope = ctx.saved_tensors
            keep = y >= 0
            grad_p = torch.where(keep, 0, grad)
            if ctx.needs_input_grad[2]:
                grad_slope = (grad_p * y).sum(
                    (0, 2, 3), keepdim=True).flatten().float()
            grad = torch.where(keep, grad, 0) \
                + grad_p * slope.to(y.dtype)[:, None, None]
        grad_bias = grad.float().sum((0, 2, 3), keepdim=True).flatten() \
            if ctx.needs_input_grad[1] else None
        return grad, grad_bias, grad_slope, None


def bias_act(x: torch.Tensor, bias: torch.Tensor, kind: str,
             slope: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`plain(x, bias, kind, slope)`; where `fuses(x)`, computed by the
    kernel over x's own memory, which then holds the result (x is
    returned), under autograd too.  x is a bfloat16 conv output
    [N, C, H, W] in channels-last memory; bias and the PReLU slope are
    float32 [C]."""
    if not fuses(x):
        return plain(x, bias, kind, slope)
    _check(x, bias, kind, slope)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, bias, slope)):
        return _BiasAct.apply(x, bias, slope if kind == "prelu" else None,
                              kind)
    _launch(x, bias, kind, slope)
    return x


bias_act.launches = 0
