"""Executors that run one network description several ways, in plain
PyTorch: a forward pass (``Forward``), a count of multiply-adds from the
shapes (``Counter``), and excitation backprop (``mwp_at``).

A network is a function ``net(ex, x)`` that calls the executor's layer
methods in the published module call order and passes the handles they
return.  Layers whose published module carries a forward hook in xfr's
EBP (every ``nn.Module`` call: convolutions, BatchNorm, ReLU, pools, the
residual ``Add``, ``Multiply``, the LightCNN ``Split``) are "hooked";
functional steps (flatten, ``F.normalize``, ``torch.max`` of a split,
the ``+`` of LightCNN's pool pair) are not.

Excitation backprop (Zhang et al., arXiv:1608.00507; xfr's version 6,
``norelu`` subtree mode, biases not swapped), as xfr computes it with
torch autograd:

1. a clean forward records every value;
2. a positive forward: each hooked module runs with ReLU'd weights (the
   bias as it is) on the ReLU of its clean input, and records the value
   that naturally arrives at each module input;
3. a backward through the network with ReLU'd weights, linearized at the
   clean values (a ReLU passes half its gradient at exactly 0, a max pool
   routes to the first maximum of its window), where a tensor hook on
   every hooked module's input rewrites the gradient g arriving there:
   p = relu(A) * relu(g) is that input's marginal winning probability
   (A the clean input) and p / (relu(X) + eps) flows on (X the positive
   pass's value there).  An in-place ReLU's hook sits on its output.
   Several hooks on one tensor chain in call order, as autograd runs
   them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _relu(t):
    return torch.clamp(t, min=0)


class Forward:
    """Plain forward: a handle is the tensor itself."""

    def __init__(self, params):
        self.p = params

    def input(self, x):
        return x

    def value(self, h):
        return h

    def conv(self, name, x, stride=1, padding=0):
        p = self.p[name]
        return F.conv2d(x, p["w"], p.get("b"), stride, padding)

    def bn(self, name, x, eps):
        p = self.p[name]
        return F.batch_norm(x, p["mean"], p["var"], p["gamma"], p["beta"],
                            False, 0.0, eps)

    def relu(self, x):
        return F.relu(x)

    def maxpool(self, x, k, s, p=0):
        return F.max_pool2d(x, k, s, p)

    def avgpool(self, x, k):
        return F.avg_pool2d(x, k, k)

    def concat_zeros(self, x, mult):
        n, c, h, w = x.shape
        return torch.cat([x, x.new_zeros((n, c * mult, h, w))], dim=1)

    def add(self, a, b):
        return a + b

    def funcadd(self, a, b):
        return a + b

    def flatten(self, x):
        return x.reshape(x.shape[0], -1)

    def linear(self, name, x):
        p = self.p[name]
        return F.linear(x, p["w"], p.get("b"))

    def l2normalize(self, x):
        return F.normalize(x, dim=1)

    def scale(self, x, c):
        return x * c

    def split(self, x):
        return x

    def pair_max(self, x):
        c = x.shape[1] // 2
        return torch.maximum(x[:, :c], x[:, c:])


class Counter:
    """Multiply-adds of convolutions and linear layers from the shapes: a
    handle is a shape tuple (batch 1)."""

    def __init__(self, shapes):
        self.macs = 0
        self.shapes = shapes

    def input(self, chw):
        return (1,) + tuple(chw)

    def conv(self, name, x, stride=1, padding=0):
        cout, cin, kh, kw = self.shapes[name]["w"]
        h = (x[2] + 2 * padding - kh) // stride + 1
        w = (x[3] + 2 * padding - kw) // stride + 1
        self.macs += cout * h * w * cin * kh * kw
        return (1, cout, h, w)

    def linear(self, name, x):
        fout, fin = self.shapes[name]["w"]
        self.macs += fout * fin
        return (1, fout)

    def maxpool(self, x, k, s, p=0):
        return (1, x[1], (x[2] + 2 * p - k) // s + 1,
                (x[3] + 2 * p - k) // s + 1)

    def avgpool(self, x, k):
        return (1, x[1], x[2] // k, x[3] // k)

    def concat_zeros(self, x, mult):
        return (1, x[1] * (mult + 1), x[2], x[3])

    def flatten(self, x):
        n = 1
        for d in x[1:]:
            n *= d
        return (1, n)

    def pair_max(self, x):
        return (1, x[1] // 2) + tuple(x[2:])

    def bn(self, name, x, eps):
        return x

    def relu(self, x):
        return x

    def add(self, a, b):
        return a

    funcadd = add

    def l2normalize(self, x):
        return x

    def scale(self, x, c):
        return x

    def split(self, x):
        return x


class _Recorded:
    """Base of the three EBP passes: a handle is an index into
    ``self.v``, the same index in every pass for one network."""

    def __init__(self, params):
        self.p = params
        self.v = []

    def _new(self, t):
        self.v.append(t)
        return len(self.v) - 1

    def input(self, x):
        return self._new(x)

    def value(self, h):
        return self.v[h]


class _Clean(_Recorded):
    """Pass 1: the ordinary forward, every value kept."""

    def __init__(self, params):
        super().__init__(params)
        self.f = Forward(params)

    def conv(self, name, h, stride=1, padding=0):
        return self._new(self.f.conv(name, self.v[h], stride, padding))

    def bn(self, name, h, eps):
        return self._new(self.f.bn(name, self.v[h], eps))

    def linear(self, name, h):
        return self._new(self.f.linear(name, self.v[h]))

    def maxpool(self, h, k, s, p=0):
        return self._new(self.f.maxpool(self.v[h], k, s, p))

    def avgpool(self, h, k):
        return self._new(self.f.avgpool(self.v[h], k))

    def concat_zeros(self, h, mult):
        return self._new(self.f.concat_zeros(self.v[h], mult))

    def scale(self, h, c):
        return self._new(self.v[h] * c)

    def add(self, a, b):
        return self._new(self.v[a] + self.v[b])

    funcadd = add

    def relu(self, h):
        return self._new(self.f.relu(self.v[h]))

    def flatten(self, h):
        return self._new(self.f.flatten(self.v[h]))

    def l2normalize(self, h):
        return self._new(self.f.l2normalize(self.v[h]))

    def split(self, h):
        return self._new(self.v[h])

    def pair_max(self, h):
        return self._new(self.f.pair_max(self.v[h]))


class _Positive(_Recorded):
    """Pass 2: hooked modules on relu(clean input) with ReLU'd weights
    (biases and BatchNorm statistics as they are); functional steps on
    the flowing positive values."""

    def __init__(self, params, clean):
        super().__init__(params)
        self.c = clean

    def _pos(self, name):
        p = dict(self.p[name])
        for k in ("w", "gamma"):
            if k in p:
                p[k] = _relu(p[k])
        return p

    def _a(self, h):
        return _relu(self.c[h])

    def conv(self, name, h, stride=1, padding=0):
        p = self._pos(name)
        return self._new(F.conv2d(self._a(h), p["w"], p.get("b"), stride,
                                  padding))

    def bn(self, name, h, eps):
        p = self._pos(name)
        return self._new(F.batch_norm(self._a(h), p["mean"], p["var"],
                                      p["gamma"], p["beta"], False, 0.0,
                                      eps))

    def linear(self, name, h):
        p = self._pos(name)
        return self._new(F.linear(self._a(h), p["w"], p.get("b")))

    def relu(self, h):
        return self._new(self._a(h))

    def maxpool(self, h, k, s, p=0):
        return self._new(F.max_pool2d(self._a(h), k, s, p))

    def avgpool(self, h, k):
        return self._new(F.avg_pool2d(self._a(h), k, k))

    def concat_zeros(self, h, mult):
        return self._new(Forward.concat_zeros(None, self._a(h), mult))

    def add(self, a, b):
        return self._new(self._a(a) + self._a(b))

    def scale(self, h, c):
        return self._new(self._a(h) * c)

    def split(self, h):
        return self._new(self._a(h))

    def funcadd(self, a, b):
        return self._new(self.v[a] + self.v[b])

    def flatten(self, h):
        return self._new(self.v[h].reshape(self.v[h].shape[0], -1))

    def l2normalize(self, h):
        return self._new(F.normalize(self.v[h], dim=1))

    def pair_max(self, h):
        return self._new(Forward.pair_max(None, self.v[h]))


class _Linearized(_Recorded):
    """Pass 3: the network with ReLU'd weights, linearized at the clean
    values, for torch autograd; each hooked module registers its tensor
    hooks as it is called."""

    def __init__(self, params, clean, pos, eps, watch, store):
        super().__init__(params)
        self.c, self.x, self.eps = clean, pos, eps
        self.watch, self.store = watch, store

    def _hook(self, t, a_h, x_h, key):
        a, xp = _relu(self.c[a_h]), _relu(self.x[x_h])
        eps, store, watched = self.eps, self.store, key == self.watch

        def rule(g):
            p = a * _relu(g)
            if watched:
                store.append(p.detach())
            return p / (xp + eps)

        t.register_hook(rule)

    def _hooked(self, key, *hs):
        for slot, h in enumerate(hs):
            self._hook(self.v[h], h, h, (key, slot))

    def _w(self, name, k="w"):
        return _relu(self.p[name][k])

    def conv(self, name, h, stride=1, padding=0):
        self._hooked(name, h)
        return self._new(F.conv2d(self.v[h], self._w(name), None, stride,
                                  padding))

    def bn(self, name, h, eps):
        self._hooked(name, h)
        p = self.p[name]
        s = self._w(name, "gamma") / torch.sqrt(p["var"] + eps)
        return self._new(self.v[h] * s[None, :, None, None])

    def linear(self, name, h):
        self._hooked(name, h)
        return self._new(F.linear(self.v[h], self._w(name)))

    def relu(self, h):
        c = self.c[h]
        m = (c > 0).to(c.dtype) + 0.5 * (c == 0).to(c.dtype)
        out = self._new(self.v[h] * m)
        # in-place module: its input hook sits on its output
        self._hook(self.v[out], out, h, (len(self.v), 0))
        return out

    def maxpool(self, h, k, s, p=0):
        self._hooked(len(self.v), h)
        _, idx = F.max_pool2d(self.c[h], k, s, p, return_indices=True)
        y = self.v[h].flatten(2).gather(2, idx.flatten(2))
        return self._new(y.reshape(idx.shape))

    def avgpool(self, h, k):
        self._hooked(len(self.v), h)
        return self._new(F.avg_pool2d(self.v[h], k, k))

    def concat_zeros(self, h, mult):
        self._hooked(len(self.v), h)
        return self._new(Forward.concat_zeros(None, self.v[h], mult))

    def add(self, a, b):
        self._hooked(len(self.v), a, b)
        return self._new(self.v[a] + self.v[b])

    def scale(self, h, c):
        self._hooked(len(self.v), h)
        return self._new(self.v[h] * c)

    def split(self, h):
        self._hooked(len(self.v), h)
        return self._new(self.v[h])

    def funcadd(self, a, b):
        return self._new(self.v[a] + self.v[b])

    def flatten(self, h):
        return self._new(self.v[h].reshape(self.v[h].shape[0], -1))

    def l2normalize(self, h):
        v = self.c[h]
        n = torch.linalg.norm(v, dim=1, keepdim=True)
        u = v / n
        x = self.v[h]
        return self._new((x - u * (u * x).sum(1, keepdim=True)) / n)

    def pair_max(self, h):
        c = self.c[h]
        half = c.shape[1] // 2
        first = (c[:, :half] > c[:, half:]).to(c.dtype) \
            + 0.5 * (c[:, :half] == c[:, half:]).to(c.dtype)
        x = self.v[h]
        return self._new(first * x[:, :half] + (1 - first) * x[:, half:])


def mwp_at(net, params, x, prior, watch, eps=1e-16):
    """The MWP that the hook of ``watch`` = (module name, input slot)
    computes, for the walk from ``prior`` at the network's output: the
    three passes above on one input batch ``x``."""
    with torch.no_grad():
        clean = _Clean(params)
        net(clean, clean.input(x))
        pos = _Positive(params, clean.v)
        net(pos, pos.input(x))
    store = []
    with torch.enable_grad():
        lin = _Linearized(params, clean.v, pos.v, eps, watch, store)
        x0 = x.detach().clone().requires_grad_(True)
        out = net(lin, lin.input(x0))
        torch.autograd.grad(lin.v[out], x0, prior)
    if len(store) != 1:
        raise RuntimeError(f"the hook of {watch} fired {len(store)} times")
    return store[0]
