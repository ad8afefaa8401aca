"""Fine-tuning step for the embedding networks (port of
xfr_tpu/train/finetune.py).

The reference ships no training loop (SURVEY.md §2.8) — matchers are frozen
checkpoints.  The JAX package adds a jitted classification step over a
(dp, mp) mesh; this is its PyTorch form: autograd through the graph
interpreter's forward, ``torch.optim`` for the update, and, over a mesh,
one process per card calling the collectives itself (``parallel.mesh``):
the batch is this rank's ``dp`` shard, the trunk is replicated, and the
large classifier (65,359 classes for STR-Janus ResNet, 80,013 for
LightCNN) is split by rows over ``mp``.

No hand-written kernel belongs here: the JAX step reaches no Pallas
kernel.  The convolutions and their gradients run in cuDNN, the
classifier product in ``torch.matmul``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from xfr_torch.ebp import interpreter as I
from xfr_torch.parallel.mesh import classifier_tp_shardings
from xfr_torch.utils.device import precision_scope, resolve_device

BN_STATS = ("mean", "var")


class _VocabParallelCrossEntropy(torch.autograd.Function):
    """Per-row softmax cross-entropy of logits whose classes are split over
    the ranks of ``group``: this rank holds classes [lo, lo + n).  The row
    max, the sum of exponentials and the target logit (held by one rank)
    are all-reduced over ``group``; the gradient of the local logits is
    the local softmax minus the local one-hot, with no collective."""

    @staticmethod
    def forward(ctx, logits, y, lo, group):
        n = logits.shape[1]
        m = logits.max(dim=1).values
        dist.all_reduce(m, dist.ReduceOp.MAX, group=group)
        e = torch.exp(logits - m[:, None])
        s = e.sum(dim=1)
        dist.all_reduce(s, group=group)
        local = y - lo
        mine = (local >= 0) & (local < n)
        idx = local.clamp(0, n - 1)
        t = torch.where(mine, logits.gather(1, idx[:, None])[:, 0], 0)
        dist.all_reduce(t, group=group)
        ctx.save_for_backward(e / s[:, None], idx, mine)
        return torch.log(s) + m - t

    @staticmethod
    def backward(ctx, g):
        p, idx, mine = ctx.saved_tensors
        grad = p.scatter_add(1, idx[:, None], -mine.to(p.dtype)[:, None])
        return grad * g[:, None], None, None, None


class _MeshGroups:
    """The collectives of one rank of a (dp, mp) mesh."""

    def __init__(self, mesh, dp_axis, mp_axis):
        self.dp = mesh.get_group(dp_axis)
        self.mp = mesh.get_group(mp_axis)
        self.dp_size = dist.get_world_size(self.dp)
        self.mp_size = dist.get_world_size(self.mp)
        self.mp_rank = mesh.get_local_rank(mp_axis)

    def class_offset(self, n_local, device):
        """The first class this rank's classifier rows hold: the sum of the
        lower mp ranks' row counts (no host sync)."""
        counts = torch.zeros(self.mp_size, dtype=torch.int64, device=device)
        counts[self.mp_rank] = n_local
        dist.all_reduce(counts, group=self.mp)
        return counts[:self.mp_rank].sum()

    def row_losses(self, logits, y):
        lo = self.class_offset(logits.shape[1], logits.device)
        return _VocabParallelCrossEntropy.apply(logits, y, lo, self.mp)

    def dp_mean(self, t):
        t = t.detach().clone()
        dist.all_reduce(t, group=self.dp)
        return t / self.dp_size

    def hits(self, logits, y):
        """Top-1 hits over the global batch; the argmax is the lowest class
        index among the ranks that hold the row max, as ``jnp.argmax``
        takes the first."""
        lo = self.class_offset(logits.shape[1], logits.device)
        v, i = logits.max(dim=1)
        vmax = v.clone()
        dist.all_reduce(vmax, dist.ReduceOp.MAX, group=self.mp)
        big = torch.iinfo(torch.int64).max
        arg = torch.where(v == vmax, i + lo, big)
        dist.all_reduce(arg, dist.ReduceOp.MIN, group=self.mp)
        hits = (arg == y).sum()
        dist.all_reduce(hits, group=self.dp)
        return hits


def _logits(graph, params, x):
    return I.forward_values(graph, params, x)[graph.output_id]


def make_train_step(graph, classifier_pname, mesh=None, dp_axis="dp",
                    mp_axis="mp", learning_rate=1e-3, optimizer=None,
                    weight_decay=0.0, train_bn_stats=False, device="cuda",
                    precision=None):
    """Returns (step_fn, init_fn).

    step_fn(params, opt_state, x, y) -> (params, opt_state, loss)
      x: [B,C,H,W] images (this rank's dp shard with a mesh); y: [B] int
      labels.  ``params`` are updated in place and returned; ``loss`` is
      the mean softmax cross-entropy over the (global) batch, a 0-dim
      tensor on the device.
    init_fn(params) -> (placed_params, opt_state)
      copies ``params`` onto the device (with a mesh: this rank's
      classifier rows) and builds the optimizer, which is the opt_state.

    ``optimizer``: a callable ``list of parameters -> torch.optim.Optimizer``
    (an optax transform has no torch form); the default is
    ``torch.optim.SGD(lr=learning_rate, momentum=0.9)``, optax.sgd's
    update.  ``weight_decay`` adds wd * param to each trained leaf's
    gradient before the optimizer's step, as the JAX package chains
    ``optax.add_decayed_weights`` before it; with the default optimizer
    that is ``SGD(weight_decay=wd)``.

    BatchNorm running statistics (the ``mean``/``var`` leaves of
    batchnorm2d params) are FROZEN by default: they are statistics, not
    weights, and descending the loss through them collapses the trunk.
    They stay out of the optimizer with ``requires_grad`` off, which is
    what the JAX step's mask of both gradients and updates produces (so
    weight decay leaves them alone too).  ``train_bn_stats=True`` trains
    them: ``ops.batchnorm2d`` is an explicit affine map in ``mean`` and
    ``var``, so they get the gradients ``jax.grad`` gives them.

    With a ``mesh`` (``parallel.mesh.make_mesh``), every rank passes the
    same ``params`` to init_fn.  The loss is a vocab-parallel
    cross-entropy over the ``mp`` ranks; the trunk's gradients are summed
    over ``mp`` (each rank's logits reach it through its own classes) and
    every gradient is averaged over ``dp``.

    ``device``: "cuda" (the default) raises without a card; pass "cpu" for
    the plain CPU path.  ``precision``: None allows TF32, as the JAX step
    runs at its default (single-pass) matmul precision; "high" runs full
    float32 (``utils.device.precision_scope``).
    """
    device = resolve_device(device)
    if mesh is not None and mesh.device_type != device.type:
        raise ValueError(f"mesh on {mesh.device_type}, step on {device}")
    groups = None if mesh is None else _MeshGroups(mesh, dp_axis, mp_axis)

    def make_optimizer(leaves):
        if optimizer is not None:
            return optimizer(leaves)
        return torch.optim.SGD(leaves, lr=learning_rate, momentum=0.9)

    def init_fn(params):
        rows = (None if mesh is None else
                classifier_tp_shardings(mesh, params, classifier_pname,
                                        axis=mp_axis))
        placed = {}
        for pname, leaves in params.items():
            placed[pname] = {}
            for k, v in leaves.items():
                v = torch.as_tensor(v, device=device)
                if rows is not None:
                    v = v[rows[pname][k]]
                placed[pname][k] = v.detach().clone().requires_grad_(
                    train_bn_stats or k not in BN_STATS)
        trained = [v for leaves in placed.values() for v in leaves.values()
                   if v.requires_grad]
        return placed, make_optimizer(trained)

    def step(params, opt_state, x, y):
        x = torch.as_tensor(x, device=device)
        y = torch.as_tensor(y, device=device).long()
        opt_state.zero_grad(set_to_none=True)
        with precision_scope(precision):
            logits = _logits(graph, params, x)
            if groups is None:
                loss = F.cross_entropy(logits, y)
            else:
                loss = groups.row_losses(logits, y).mean()
            del logits
            loss.backward()
        if groups is not None:
            for pname, leaves in params.items():
                for v in leaves.values():
                    if v.grad is None:
                        continue
                    if pname != classifier_pname:
                        dist.all_reduce(v.grad, group=groups.mp)
                    dist.all_reduce(v.grad, group=groups.dp)
                    v.grad /= groups.dp_size
            loss = groups.dp_mean(loss)
        if weight_decay:
            for group in opt_state.param_groups:
                for v in group["params"]:
                    if v.grad is not None:
                        v.grad.add_(v.detach(), alpha=weight_decay)
        opt_state.step()
        return params, opt_state, loss.detach()

    return step, init_fn


def make_eval_step(graph, mesh=None, dp_axis="dp", mp_axis="mp",
                   device="cuda", precision=None):
    """Validation step: (params, x, y) -> (mean loss, top-1 hits), 0-dim
    tensors on the device.

    Functional analog of the reference's `run_validation`/
    `load_val_batches` (xfr/utils.py:337-355, dead code there).  With a
    mesh, ``x``/``y`` are this rank's dp shard and ``params`` hold this
    rank's classifier rows (make_train_step's init_fn): the loss is the
    global batch's mean and the hits its sum.  BatchNorm stats are explicit
    params here, so eval is frozen-stats by construction."""
    device = resolve_device(device)
    if mesh is not None and mesh.device_type != device.type:
        raise ValueError(f"mesh on {mesh.device_type}, step on {device}")
    groups = None if mesh is None else _MeshGroups(mesh, dp_axis, mp_axis)

    @torch.no_grad()
    def step(params, x, y):
        x = torch.as_tensor(x, device=device)
        y = torch.as_tensor(y, device=device).long()
        with precision_scope(precision):
            logits = _logits(graph, params, x)
        if groups is None:
            return (F.cross_entropy(logits, y),
                    (logits.argmax(dim=-1) == y).sum())
        loss = groups.dp_mean(groups.row_losses(logits, y).mean())
        return loss, groups.hits(logits, y)

    return step
