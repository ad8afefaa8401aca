"""Primitive tensor ops for the graph IR (port of xfr_tpu/ops.py).

Every op is a plain function ``fwd(params, xs, **attrs) -> y`` over NCHW
tensors, where ``params`` is a (possibly empty) dict of tensors and ``xs``
a tuple of input tensors.  Backward rules for excitation backprop come
from ``torch.autograd.grad`` linearized at the clean inputs (``op_vjp``);
for affine ops the caller passes ReLU'd ("positive") weights.

Every op of the JAX package's registry is ported: those of
ResNet-101+L2, and those of LightCNN-29 v2 (split_identity, pair_max,
dropout_eval), VGGFace2 SENet-50 (global_avgpool2d, mul, sigmoid) and
VGG-16.

Gradients follow the JAX rules, not torch's module defaults:
  * relu is ``torch.maximum(x, 0)``, whose gradient at x == 0 is 0.5
    like ``jax.vjp(jnp.maximum)`` (``torch.relu`` gives 0);
  * pair_max splits a tie 0.5/0.5 between its two halves, as
    ``jnp.maximum`` does;
  * maxpool pads with -inf and routes a tie to the first maximum of its
    window, as JAX's reduce_window does.

``op_vjp_rows`` is the same vjp for a cotangent with a leading row axis
(``jax.vmap(vjp_fn)``), written out op by op so that no forward is
recomputed and no row is looped over.  Every backward walk of the port
goes through it; ``op_vjp`` remains its autograd fallback (l2normalize)
and the oracle its rules are tested against.  A rule is written out for
every op that sits inside a network (a walk of LightCNN crosses 29
pair_max nodes): the fallback would copy the op's capture once per row.
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


def global_avgpool2d(params, xs):
    """AdaptiveAvgPool2d(1) (used by SENet SE blocks)."""
    (x,) = xs
    return torch.mean(x, dim=(2, 3), keepdim=True)


def add(params, xs):
    """Residual add exposed as a hooked module."""
    x, y = xs
    return x + y


def mul(params, xs):
    """Elementwise (broadcasting) product, e.g. SE gating."""
    x, y = xs
    return x * y


def multiply_const(params, xs, *, c=1.0):
    """Multiply(n) module."""
    (x,) = xs
    return x * c


def concat_zero_channels(params, xs, *, mult=1):
    """ConcatChannels: pad channels with zeros by concatenation.  The
    zeros take x's memory format, so that a channels_last block's
    residual stays channels_last (the values do not depend on it)."""
    (x,) = xs
    n, c, h, w = x.shape
    last = not x.is_contiguous() and x.is_contiguous(
        memory_format=torch.channels_last)
    zeros = torch.empty((n, c * mult, h, w), dtype=x.dtype, device=x.device,
                        memory_format=torch.channels_last if last
                        else torch.contiguous_format).zero_()
    return torch.cat([x, zeros], dim=1)


def split_identity(params, xs):
    """Stand-in for the LightCNN ``Split`` module hook point.  The actual
    split+max happens in the (unhooked) ``pair_max`` op that follows."""
    (x,) = xs
    return x


def pair_max(params, xs):
    """torch.max(split[0], split[1]) of a channel-halved tensor."""
    (x,) = xs
    c = x.shape[1] // 2
    return torch.maximum(x[:, :c], x[:, c:])


def flatten(params, xs):
    (x,) = xs
    return x.reshape(x.shape[0], -1)


def l2normalize(params, xs, *, axis=1, eps=1e-12):
    """F.normalize(x, p=2, dim=axis)."""
    (x,) = xs
    n = torch.sqrt(torch.sum(x * x, dim=axis, keepdim=True))
    return x / torch.clamp(n, min=eps)


def dropout_eval(params, xs):
    """F.dropout at eval time: identity."""
    (x,) = xs
    return x


def sigmoid(params, xs):
    (x,) = xs
    return torch.sigmoid(x)


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
    "global_avgpool2d": global_avgpool2d,
    "add": add,
    "mul": mul,
    "multiply_const": multiply_const,
    "concat_zero_channels": concat_zero_channels,
    "split_identity": split_identity,
    "pair_max": pair_max,
    "flatten": flatten,
    "l2normalize": l2normalize,
    "dropout_eval": dropout_eval,
    "sigmoid": sigmoid,
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


# ---------------------------------------------------------------------------
# Row-batched vjp: the counterpart of jax.vmap(vjp_fn)(g)
# ---------------------------------------------------------------------------
#
# The cotangent carries a leading row axis (candidate rows of the
# weighted-subtree sweep, or the mate/nonmate cotangents of one forward
# pair) that the captures ``xs`` do not have.  Linear ops fold the rows
# into the batch axis and never run their forward; relu and maxpool
# broadcast the clean capture's routing over the rows.  The rules are
# those of ``op_vjp``: relu passes 0.5 at exactly 0, maxpool routes a tie
# to the first maximum of its window and sums overlapping windows in a
# fixed order.


def _fold(g):
    """[R, P, ...] -> [R*P, ...]."""
    return g.reshape((g.shape[0] * g.shape[1],) + tuple(g.shape[2:]))


def _rows_conv2d(params, xs, g, *, stride=(1, 1), padding=(0, 0),
                 dilation=(1, 1)):
    (x,) = xs
    gf = _fold(g)
    gx = torch.nn.grad.conv2d_input(
        (gf.shape[0],) + tuple(x.shape[1:]), params["w"], gf,
        _pair(stride), _pair(padding), _pair(dilation))
    return (gx.reshape((g.shape[0],) + tuple(x.shape)),)


def _rows_linear(params, xs, g):
    return (g @ params["w"],)


def _rows_batchnorm2d(params, xs, g, *, eps=1e-5):
    scale = params["gamma"] / torch.sqrt(params["var"] + eps)
    return (g * scale[:, None, None],)


def _rows_relu(params, xs, g):
    (x,) = xs
    slope = (x > 0).to(g.dtype) + 0.5 * (x == 0).to(g.dtype)
    return (g * slope,)


def _unpad(gp, x, kernel, stride, padding, ceil_mode):
    """Adjoint of ``_pool_pad``: a zero pad's adjoint is the opposite pad
    (crop where it padded, zeros where it cropped)."""
    h, w = x.shape[-2:]
    oh = _pool_out_size(h, kernel[0], stride[0], padding[0], ceil_mode)
    ow = _pool_out_size(w, kernel[1], stride[1], padding[1], ceil_mode)
    rh = (oh - 1) * stride[0] + kernel[0] - h - padding[0]
    rw = (ow - 1) * stride[1] + kernel[1] - w - padding[1]
    return F.pad(gp, (-padding[1], -rw, -padding[0], -rh))


def _rows_maxpool2d(params, xs, g, *, kernel=(2, 2), stride=None,
                    padding=(0, 0), ceil_mode=False):
    (x,) = xs
    kernel, padding = _pair(kernel), _pair(padding)
    stride = kernel if stride is None else _pair(stride)
    xp = _pool_pad(x, kernel, stride, padding, ceil_mode, float("-inf"))
    # the first maximum of each window, as a flat index into its plane
    _, idx = F.max_pool2d(xp, kernel, stride, return_indices=True)
    hp, wp = xp.shape[-2:]
    ho, wo = idx.shape[-2:]
    rows = torch.arange(ho, device=idx.device)[:, None] * (stride[0] * wp)
    cols = torch.arange(wo, device=idx.device) * stride[1]
    # that maximum's place in its window, i * wp + j for offset (i, j)
    off = idx - (rows + cols)
    gp = g.new_zeros((g.shape[0],) + tuple(xp.shape))
    # Overlapping windows (3x3, stride 2) send several cotangents to one
    # input.  They are summed by window offset, in a fixed order, each
    # offset a strided slice of the input that no two windows share: the
    # same bits on every run, where a scatter-add's order is the card's.
    for i in range(kernel[0]):
        for j in range(kernel[1]):
            hit = off == i * wp + j
            gp[..., i:i + (ho - 1) * stride[0] + 1:stride[0],
               j:j + (wo - 1) * stride[1] + 1:stride[1]].add_(
                   torch.where(hit, g, 0))
    gx = _unpad(gp, x, kernel, stride, padding, ceil_mode)
    return (gx,)


def _rows_avgpool2d(params, xs, g, *, kernel=(2, 2), stride=None,
                    padding=(0, 0), ceil_mode=False):
    (x,) = xs
    kernel, padding = _pair(kernel), _pair(padding)
    stride = kernel if stride is None else _pair(stride)
    gf = _fold(g)
    ho, wo = g.shape[-2:]
    # the padded input's shape; its values are never read, so one element
    # expanded stands in for it
    shape = (gf.shape[0], x.shape[1], (ho - 1) * stride[0] + kernel[0],
             (wo - 1) * stride[1] + kernel[1])
    gp = torch.ops.aten.avg_pool2d_backward(
        gf, gf.new_empty(1).expand(shape), list(kernel), list(stride),
        [0, 0], False, True, None)
    gp = gp.reshape((g.shape[0], x.shape[0]) + tuple(gp.shape[1:]))
    return (_unpad(gp, x, kernel, stride, padding, ceil_mode),)


def _rows_global_avgpool2d(params, xs, g):
    (x,) = xs
    h, w = x.shape[-2:]
    return ((g / (h * w)).expand((g.shape[0],) + tuple(x.shape)),)


def _rows_add(params, xs, g):
    return (g, g)


def _sum_to(t, shape):
    """Sum a [R, *out] product down to [R, *shape] (``shape`` of out's
    rank), the adjoint of broadcasting ``shape`` to ``out``."""
    dims = tuple(i + 1 for i, n in enumerate(shape)
                 if n == 1 and t.shape[i + 1] != 1)
    return t.sum(dim=dims, keepdim=True) if dims else t


def _rows_mul(params, xs, g):
    x, y = xs
    return (_sum_to(g * y, tuple(x.shape)), _sum_to(g * x, tuple(y.shape)))


def _rows_multiply_const(params, xs, g, *, c=1.0):
    return (g * c,)


def _rows_concat_zero_channels(params, xs, g, *, mult=1):
    (x,) = xs
    return (g[:, :, :x.shape[1]],)


def _rows_pair_max(params, xs, g):
    """A tie sends half of the gradient to each half (jnp.maximum's
    rule; a ``where(a > b)`` would send all of it to one)."""
    (x,) = xs
    c = x.shape[1] // 2
    a, b = x[:, :c], x[:, c:]
    tie = 0.5 * (a == b).to(g.dtype)
    return (torch.cat([g * ((a > b).to(g.dtype) + tie),
                       g * ((a < b).to(g.dtype) + tie)], dim=2),)


def _rows_sigmoid(params, xs, g):
    (x,) = xs
    s = torch.sigmoid(x)
    return (g * (s * (1 - s)),)


def _rows_flatten(params, xs, g):
    (x,) = xs
    return (g.reshape((g.shape[0],) + tuple(x.shape)),)


def _rows_identity(params, xs, g):
    return (g,)


def _rows_by_autograd(op, params, xs, g, attrs):
    """Any per-sample op: autograd over the capture repeated for each row,
    rows folded into the batch axis (one call, no per-row loop)."""
    r = g.shape[0]
    rep = tuple(x.unsqueeze(0).expand((r,) + tuple(x.shape)) for x in xs)
    grads = op_vjp(op, params, tuple(_fold(x) for x in rep), attrs, _fold(g))
    return tuple(gx.reshape(x.shape) for gx, x in zip(grads, rep))


_ROW_VJPS = {
    "conv2d": _rows_conv2d,
    "linear": _rows_linear,
    "batchnorm2d": _rows_batchnorm2d,
    "relu": _rows_relu,
    "maxpool2d": _rows_maxpool2d,
    "avgpool2d": _rows_avgpool2d,
    "global_avgpool2d": _rows_global_avgpool2d,
    "add": _rows_add,
    "mul": _rows_mul,
    "multiply_const": _rows_multiply_const,
    "concat_zero_channels": _rows_concat_zero_channels,
    "split_identity": _rows_identity,
    "pair_max": _rows_pair_max,
    "flatten": _rows_flatten,
    "dropout_eval": _rows_identity,
    "sigmoid": _rows_sigmoid,
    "identity": _rows_identity,
}


def op_vjp_rows(op, params, xs, attrs, g_rows):
    """``op_vjp`` for a cotangent with a leading row axis: ``g_rows``
    [R, *out] at captures ``xs`` without one -> per input [R, *in].

    Row r of the result equals ``op_vjp(op, params, xs, attrs,
    g_rows[r])``.  l2normalize (a [P, D] head op) goes through autograd
    with the rows folded into its batch."""
    rule = _ROW_VJPS.get(op)
    if rule is None:
        return _rows_by_autograd(op, params, xs, g_rows, attrs)
    return rule(params, xs, g_rows, **attrs)
