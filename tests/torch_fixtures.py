"""Shared helpers of the xfr_torch parity tests: the port's twin of
tests/fixtures.make_toy_wbnet, built with the port's GraphBuilder and
carrying the JAX net's parameters across."""

import json
import os
import subprocess
import sys

import numpy as np
import torch

from xfr_torch.ebp.engine import Whitebox, WhiteboxNetwork
from xfr_torch.graph import GraphBuilder
from xfr_torch.models.convert import params_from_jax

# six xdist workers share the host's cores
torch.set_num_threads(2)


def jax_params_np(params, dtype=None):
    """JAX params pytree -> {pname: {key: numpy array}}."""
    return {k: {kk: np.asarray(vv, dtype) for kk, vv in v.items()}
            for k, v in params.items()}


def toy_preprocess(im):
    """tests/fixtures.toy_preprocess on the port: uint8/float HWC RGB ->
    [1,3,224,224] float32 in [0,1] on the CPU."""
    from xfr_torch.utils.image import resize

    arr = np.asarray(im, np.float64)
    if arr.max() > 1.5:
        arr = arr / 255.0
    if arr.shape[:2] != (224, 224):
        arr = resize(arr, (224, 224))
    return torch.from_numpy(
        np.ascontiguousarray(arr.transpose(2, 0, 1)[None], np.float32))


def toy_graph():
    """The graph of tests/fixtures.make_toy_wbnet, built by the port."""
    g = GraphBuilder("toynet")
    x = g.conv2d(0, 3, 8, 7, stride=4, padding=3, name="conv1")
    x = g.batchnorm2d(x, 8, name="bn1")
    x = g.relu(x, inplace=True)
    x = g.maxpool2d(x, 2)
    x = g.conv2d(x, 8, 16, 3, stride=2, padding=1, name="conv2")
    x = g.relu(x, inplace=True)
    x = g.avgpool2d(x, 14)
    x = g.flatten(x)
    x = g.linear(x, 16, 12, name="fc1")
    x = g.l2normalize(x)
    enc = g.multiply_const(x, 50.0)
    out = g.linear(enc, 12, 5, bias=False, name="fc2")
    return g, enc, out


def torch_twin(jax_wb, dtype=None, with_bias=None):
    """The port's Whitebox over the same toy graph and the JAX net's
    parameters, on the CPU."""
    g, enc, out = toy_graph()
    graph = g.finalize(out)
    num_classes = jax_wb.net.num_classes()
    # fc2's shape (num_classes) lives in the params, not in the graph
    params = params_from_jax(jax_params_np(jax_wb.net.params, dtype),
                             device="cpu")
    net = WhiteboxNetwork(graph, params, encode_tensor=enc,
                          classifier_pname="fc2", num_classes=num_classes,
                          preprocess=toy_preprocess, embed_dim=12,
                          name="toynet")
    wb = Whitebox(net, ebp_version=6,
                  ebp_subtree_mode=jax_wb.ebp_subtree_mode(),
                  eps=jax_wb.eps, with_bias=with_bias)
    wb.match_threshold = jax_wb.match_threshold
    wb.platts_scaling = jax_wb.platts_scaling
    return wb


def twin_graph(jgraph):
    """The port's GraphDef over the nodes of a JAX package graph (the
    event schedule is the port's own, derived from the same nodes)."""
    import dataclasses

    from xfr_torch.graph import GraphDef, Node

    return GraphDef([Node(**dataclasses.asdict(n)) for n in jgraph.nodes],
                    jgraph.n_tensors, jgraph.input_id, jgraph.output_id,
                    name=jgraph.name)


def twin_whitebox(jax_wb, dtype=None, graph=None, ebp_version=None,
                  preprocess=None, **wb_kw):
    """The port's Whitebox over a JAX Whitebox's net (its graph's nodes,
    or ``graph``, and its parameters) on the CPU, with the JAX engine's
    subtree mode, eps, ebp version and calibration, and ``preprocess``."""
    jnet = jax_wb.net
    net = WhiteboxNetwork(
        graph or twin_graph(jnet.graph),
        params_from_jax(jax_params_np(jnet.params, dtype), device="cpu"),
        encode_tensor=jnet.encode_tensor,
        classifier_pname=jnet.classifier_pname,
        num_classes=jnet.num_classes(), preprocess=preprocess,
        embed_dim=jnet.embed_dim, name=jnet.name)
    wb = Whitebox(net, ebp_version=ebp_version or jax_wb.ebp_ver,
                  ebp_subtree_mode=jax_wb.ebp_subtree_mode(),
                  eps=jax_wb.eps, **wb_kw)
    wb.match_threshold = jax_wb.match_threshold
    wb.platts_scaling = jax_wb.platts_scaling
    return wb


class FakeNet:
    """A deterministic stand-in for the Faster R-CNN network
    (``FasterRCNN(net=FakeNet())`` in either package) whose detections
    depend on the image blob: RoIs, deltas and class probabilities drawn from a
    generator seeded by the blob's content.  Records each call's blob
    shape."""

    def __init__(self, n_rois=40):
        self.n_rois = n_rois
        self.calls = []

    def __call__(self, im_blob, im_info):
        im_blob = np.asarray(im_blob)
        self.calls.append(im_blob.shape)
        h, w = im_blob.shape[2:]
        seed = int(np.abs(im_blob.astype(np.float64)).sum() * 1000) % 2**31
        rng = np.random.RandomState(seed)
        xy = rng.rand(self.n_rois, 2) * [w * 0.6, h * 0.6]
        wh = rng.rand(self.n_rois, 2) * [w * 0.4, h * 0.4] + 8
        rois = np.hstack([np.zeros((self.n_rois, 1)), xy, xy + wh])
        bbox_pred = (rng.randn(self.n_rois, 8) * 0.1).astype(np.float32)
        score = rng.randn(self.n_rois, 2).astype(np.float32)
        prob = np.exp(score) / np.exp(score).sum(axis=1, keepdims=True)
        return rois.astype(np.float32), bbox_pred, prob, score


# ---------------------------------------------------------------------------
# Spawned torch.distributed groups (gloo on the CPU, file:// rendezvous)
# ---------------------------------------------------------------------------

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spawn_ranks(worker, world, tmp_dir, *args, timeout=240):
    """Run ``tests.torch_fixtures.<worker>(rank, world, init_file, *args)``
    in ``world`` fresh processes joined by a gloo group through a file in
    ``tmp_dir`` (no port).  Every process must exit 0 within ``timeout``
    seconds; a process left running is killed.  Returns their outputs."""
    init_file = os.path.join(str(tmp_dir), "rendezvous")
    code = ("import sys, json; sys.path.insert(0, %r)\n"
            "import tests.torch_fixtures as F\n"
            "a = json.loads(sys.argv[1])\n"
            "getattr(F, a[0])(*a[1:])\n" % _REPO)
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                        "LOCAL_RANK")}
    procs = [subprocess.Popen(
        [sys.executable, "-c", code,
         json.dumps([worker, rank, world, init_file] + list(args))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        cwd=_REPO) for rank in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


def save_params(path, params, **extra):
    """{pname: {key: array or tensor}} (and extra arrays) -> one npz."""
    flat = {"%s|%s" % (p, k): np.asarray(
        v.detach().cpu().numpy() if torch.is_tensor(v) else v)
        for p, leaves in params.items() for k, v in leaves.items()}
    np.savez(path, **flat, **extra)


def load_params(path):
    """save_params' npz -> ({pname: {key: CPU tensor}}, {extra arrays})."""
    params, extra = {}, {}
    with np.load(path) as d:
        for key in d.files:
            if "|" in key:
                p, k = key.split("|")
                params.setdefault(p, {})[k] = torch.from_numpy(d[key])
            else:
                extra[key] = d[key]
    return params, extra


def mesh_train_worker(rank, world, init_file, data, out_dir, steps,
                      weight_decay, learning_rate):
    """One rank of a 2x2 (dp, mp) mesh: ``steps`` make_train_step steps on
    the toy graph with the params, x and y of ``data``, then the eval
    step; writes this rank's params, losses and hits to
    ``out_dir/rank<r>.npz``."""
    import torch.distributed as dist

    from xfr_torch.parallel import distributed as D
    from xfr_torch.parallel import mesh as M
    from xfr_torch.train.finetune import make_eval_step, make_train_step

    D.initialize("file://" + init_file, world, rank)
    mesh = M.make_mesh((2, 2), ("dp", "mp"))
    params, d = load_params(data)
    g, _, out = toy_graph()
    graph = g.finalize(out)
    step, init = make_train_step(graph, "fc2", mesh=mesh, device="cpu",
                                 weight_decay=weight_decay,
                                 learning_rate=learning_rate)
    p, o = init(params)
    x, _ = M.shard_batch(mesh, d["x"], axis="dp")
    y, _ = M.shard_batch(mesh, d["y"], axis="dp")
    losses = []
    for _ in range(steps):
        p, o, loss = step(p, o, x, y)
        losses.append(float(loss))
    ev_loss, hits = make_eval_step(graph, mesh=mesh, device="cpu")(p, x, y)
    save_params(os.path.join(out_dir, "rank%d.npz" % rank), p,
                losses=np.asarray(losses), eval_loss=float(ev_loss),
                hits=int(hits), dp=mesh.get_local_rank("dp"),
                mp=mesh.get_local_rank("mp"))
    dist.destroy_process_group()


def distributed_smoke_worker(rank, world, init_file, out_dir):
    """One rank of a 2-process gloo group: initialize, process_info, an
    all-reduce, partition_jobs and resolve_shards by rank, the mesh
    helpers, and the file barrier; the primary writes the all-reduced sum
    after the barrier."""
    import argparse

    import torch.distributed as dist

    from xfr_torch.cli.generate_wb_saliency import resolve_shards
    from xfr_torch.parallel import distributed as D
    from xfr_torch.parallel import mesh as M

    D.initialize("file://" + init_file, world, rank)
    assert D.process_info() == (rank, world), D.process_info()
    t = torch.tensor([float(rank) + 1.0])
    dist.all_reduce(t)
    jobs = D.partition_jobs(list(range(10)), shuffle=True, seed=7)
    args = argparse.Namespace(shard_index=None, num_shards=None)
    explicit = argparse.Namespace(shard_index=1, num_shards=None)

    mesh = M.make_mesh()
    assert M.auto_mesh() is not None and M.auto_mesh(min_devices=3) is None
    x5 = np.arange(5 * 3, dtype=np.float32).reshape(5, 3)
    rows, n = M.shard_batch(mesh, x5, axis="dp")
    mesh_mp = M.make_mesh((1, 2), ("dp", "mp"))
    params = {"fc2": {"w": torch.zeros(7, 4), "b": torch.zeros(7)},
              "fc1": {"w": torch.zeros(4, 4)}}
    sh = M.classifier_tp_shardings(mesh_mp, params, "fc2")
    rep = M.replicate(mesh_mp, {"a": {"w": torch.full((3,), float(rank))}})

    D.barrier_via_files(out_dir, "done", timeout_s=120)
    rec = {"jobs": jobs, "resolve": resolve_shards(args),
           "resolve_explicit": resolve_shards(explicit),
           "primary": D.is_primary(), "sum": float(t),
           "mesh_key": M.mesh_key(mesh), "rows": rows.tolist(), "n": n,
           "sharding": {p: {k: [s.start, s.stop] for k, s in v.items()}
                        for p, v in sh.items()},
           "placements": [str(p) for p in M.data_sharding(mesh, "dp", 4)],
           "replicated": rep["a"]["w"].tolist()}
    with open(os.path.join(out_dir, "rank%d.json" % rank), "w") as f:
        json.dump(rec, f)
    dist.destroy_process_group()
