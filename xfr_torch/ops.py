"""Primitive tensor ops for the graph IR (port of xfr_tpu/ops.py).

Every op is a plain function ``fwd(params, xs, **attrs) -> y`` over NCHW
tensors, where ``params`` is a (possibly empty) dict of tensors and ``xs``
a tuple of input tensors.  Backward rules for excitation backprop come
from ``torch.autograd.grad`` linearized at the clean inputs (``op_vjp``);
for affine ops the caller passes ReLU'd ("positive") weights.

Only the ops of the ResNet-101+L2 graph are ported; the LightCNN and
SENet ops (split_identity, pair_max, mul, global_avgpool2d, sigmoid,
dropout_eval) wait for their models (ROADMAP item 7).

Gradients follow the JAX rules, not torch's module defaults:
  * relu is ``torch.maximum(x, 0)``, whose gradient at x == 0 is 0.5
    like ``jax.vjp(jnp.maximum)`` (``torch.relu`` gives 0);
  * maxpool pads with -inf and routes a tie to the first maximum of its
    window, as JAX's reduce_window does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


def _pair(v):
    if isinstance(v, (tuple, list)):
        return tuple(int(x) for x in v)
    return (int(v), int(v))


def _pool_out_size(size, k, s, p, ceil_mode):
    """Output size of a torch pooling op (torch.nn.MaxPool2d semantics).

    With ceil_mode, a window that would start entirely inside the right/bottom
    padding is dropped (torch rule).
    """
    if ceil_mode:
        out = int(math.ceil((size + 2 * p - k) / s)) + 1
        if (out - 1) * s >= size + p:
            out -= 1
    else:
        out = int(math.floor((size + 2 * p - k) / s)) + 1
    return out


def _pool_pad(x, kernel, stride, padding, ceil_mode, value):
    """Explicit (left, right) padding of H and W so that an unpadded pool
    yields ``_pool_out_size`` outputs; negative right padding crops, as in
    lax.reduce_window."""
    h, w = x.shape[-2:]
    oh = _pool_out_size(h, kernel[0], stride[0], padding[0], ceil_mode)
    ow = _pool_out_size(w, kernel[1], stride[1], padding[1], ceil_mode)
    pad_h = (padding[0], (oh - 1) * stride[0] + kernel[0] - h - padding[0])
    pad_w = (padding[1], (ow - 1) * stride[1] + kernel[1] - w - padding[1])
    return F.pad(x, pad_w + pad_h, value=value)


# ---------------------------------------------------------------------------
# Forward implementations
# ---------------------------------------------------------------------------


def conv2d(params, xs, *, stride=(1, 1), padding=(0, 0), dilation=(1, 1)):
    """2-D convolution, NCHW x OIHW."""
    (x,) = xs
    y = F.conv2d(x, params["w"], None, _pair(stride), _pair(padding),
                 _pair(dilation))
    b = params.get("b")
    if b is not None:
        y = y + b[None, :, None, None]
    return y


def linear(params, xs):
    """y = x @ W^T + b (torch.nn.Linear layout: W is [out, in])."""
    (x,) = xs
    y = x @ params["w"].T
    b = params.get("b")
    if b is not None:
        y = y + b
    return y


def batchnorm2d(params, xs, *, eps=1e-5):
    """Inference-mode BatchNorm2d as an explicit affine map, kept unfolded
    so that the EBP positive-weight swap can ReLU gamma alone."""
    (x,) = xs
    mean = params["mean"][None, :, None, None]
    var = params["var"][None, :, None, None]
    gamma = params["gamma"][None, :, None, None]
    beta = params["beta"][None, :, None, None]
    return (x - mean) / torch.sqrt(var + eps) * gamma + beta


def relu(params, xs):
    (x,) = xs
    return torch.maximum(x, x.new_zeros(()))


def maxpool2d(params, xs, *, kernel=(2, 2), stride=None, padding=(0, 0),
              ceil_mode=False):
    (x,) = xs
    kernel, padding = _pair(kernel), _pair(padding)
    stride = kernel if stride is None else _pair(stride)
    xp = _pool_pad(x, kernel, stride, padding, ceil_mode, float("-inf"))
    return F.max_pool2d(xp, kernel, stride)


def avgpool2d(params, xs, *, kernel=(2, 2), stride=None, padding=(0, 0),
              ceil_mode=False):
    """AvgPool2d with count_include_pad=True (torch default): zero padding,
    every window divided by the full window size."""
    (x,) = xs
    kernel, padding = _pair(kernel), _pair(padding)
    stride = kernel if stride is None else _pair(stride)
    xp = _pool_pad(x, kernel, stride, padding, ceil_mode, 0.0)
    return F.avg_pool2d(xp, kernel, stride)


def add(params, xs):
    """Residual add exposed as a hooked module."""
    x, y = xs
    return x + y


def multiply_const(params, xs, *, c=1.0):
    """Multiply(n) module."""
    (x,) = xs
    return x * c


def concat_zero_channels(params, xs, *, mult=1):
    """ConcatChannels: pad channels with zeros by concatenation."""
    (x,) = xs
    n, c, h, w = x.shape
    zeros = x.new_zeros((n, c * mult, h, w))
    return torch.cat([x, zeros], dim=1)


def flatten(params, xs):
    (x,) = xs
    return x.reshape(x.shape[0], -1)


def l2normalize(params, xs, *, axis=1, eps=1e-12):
    """F.normalize(x, p=2, dim=axis)."""
    (x,) = xs
    n = torch.sqrt(torch.sum(x * x, dim=axis, keepdim=True))
    return x / torch.clamp(n, min=eps)


def identity(params, xs):
    (x,) = xs
    return x


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

OPS = {
    "conv2d": conv2d,
    "linear": linear,
    "batchnorm2d": batchnorm2d,
    "relu": relu,
    "maxpool2d": maxpool2d,
    "avgpool2d": avgpool2d,
    "add": add,
    "multiply_const": multiply_const,
    "concat_zero_channels": concat_zero_channels,
    "flatten": flatten,
    "l2normalize": l2normalize,
    "identity": identity,
}

# Ops whose params are "weights" in the sense of the EBP positive-weight swap.
_POS_PARAM_KEYS = {
    "conv2d": ("w",),
    "linear": ("w",),
    "batchnorm2d": ("gamma",),
}
_POS_BIAS_KEYS = {
    "conv2d": ("b",),
    "linear": ("b",),
    "batchnorm2d": ("beta",),
}


def positive_params(op, params, with_bias=False):
    """ReLU the weight (and optionally bias) entries of ``params``.

    The bias is swapped only when the Whitebox was built with
    with_bias=True (ebp_version 11).  BatchNorm running statistics are
    never touched.
    """
    if not params:
        return params
    out = dict(params)
    for k in _POS_PARAM_KEYS.get(op, ()):
        if out.get(k) is not None:
            out[k] = torch.clamp(out[k], min=0)
    if with_bias:
        for k in _POS_BIAS_KEYS.get(op, ()):
            if out.get(k) is not None:
                out[k] = torch.clamp(out[k], min=0)
    return out


def apply_op(op, params, xs, attrs):
    return OPS[op](params, xs, **attrs)


def op_vjp(op, params, xs, attrs, cotangent):
    """Contributions of ``cotangent`` (grad at the op output) to each input.

    Linearized at the clean forward inputs ``xs``: nonlinear ops route
    gradients by the clean activations while affine ops use whatever
    ``params`` are passed here (positive ones for EBP).  An input the
    output does not depend on gets a zero contribution.
    """
    with torch.enable_grad():
        inputs = tuple(x.detach().requires_grad_(True) for x in xs)
        y = OPS[op](params, inputs, **attrs)
        grads = torch.autograd.grad(y, inputs, cotangent, allow_unused=True)
    return tuple(torch.zeros_like(x) if g is None else g
                 for x, g in zip(xs, grads))
