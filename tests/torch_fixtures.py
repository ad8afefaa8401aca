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


# ---------------------------------------------------------------------------
# The inference side under a device mesh (tests/test_torch_mesh.py)
# ---------------------------------------------------------------------------


def toy_whitebox(params, num_classes, mode, dtype=None):
    """The port's toy Whitebox (tests/fixtures.make_toy_wbnet's graph,
    eps 1e-12, calibration 0.9 / 10.0) over ``params`` on the CPU, cast to
    ``dtype`` if given.  Imports no JAX."""
    g, enc, out = toy_graph()
    params = {k: {kk: vv.clone() if dtype is None else vv.to(dtype)
                  for kk, vv in v.items()} for k, v in params.items()}
    net = WhiteboxNetwork(g.finalize(out), params, encode_tensor=enc,
                          classifier_pname="fc2", num_classes=num_classes,
                          preprocess=toy_preprocess, embed_dim=12,
                          name="toynet")
    wb = Whitebox(net, ebp_version=6, ebp_subtree_mode=mode, eps=1e-12)
    wb.match_threshold, wb.platts_scaling = 0.9, 10.0
    return wb


MESH_T, MESH_T_MULTI = 13, 11  # blend families: one, and three, maps
WS_TOPK = 3


def mesh_strise(wb, d, mesh, **kw):
    """STRise over the toy net ``wb`` on the CPU with the test's probe,
    gallery and seed (``kw`` overrides)."""
    from xfr_torch.blackbox.strise import STRise

    base = dict(probe=d["st_probe"], refs=[d["st_probe"]],
                gallery=[d["st_gal"]], black_box="resnetv6_pytorch",
                net_dict={("resnetv6_pytorch", 6): wb,
                          ("resnetv4_pytorch", None): wb},
                prior_type="mean_ebp", num_masks=40, mask_scale=28,
                num_mask_elements=2, mask_fill_type="blur", seed=5,
                batch_size=16, device="cpu", mesh=mesh)
    base.update(kw)
    return STRise(**base)


def _strise_injected(st, d, fused_finish=False):
    """The evaluate() steps with the test's grids and shifts in place of
    the drawn masks; ``fused_finish`` drains through the one-fetch
    finisher of launch_evaluate's materialized-mask path."""
    st.priors[st.prior_type]()
    st._grids_dev = torch.from_numpy(d["st_grids"])
    st._shifts_dev = torch.from_numpy(d["st_shifts"])
    st._masks_dev_cache = None
    st._masks_np = None
    st.apply_masks()
    if fused_finish:
        st._score_masks_launch(want_fused_finish=True)()
        return st
    st.score_masks()
    st.compute_saliency_map()
    return st


def mesh_entry_results(data, mesh=None):
    """Every batched entry point of the inference side on the toy net,
    under ``mesh`` (None: the plain port): {name: numpy array}.  The
    inputs come from ``data`` (save_params' npz)."""
    from xfr_torch.inpainting_game.protocol import TwinClsBatch

    params, d = load_params(data)
    nc, mode = int(d["num_classes"]), str(d["mode"])
    res = {}

    def fresh(dtype=None):
        wb = toy_whitebox(params, nc, mode, dtype)
        wb.batch_size = 8
        return wb.use_mesh(mesh)

    wb = fresh()
    res["emb"] = wb.embeddings(d["probes"])
    res["encode"] = wb.encode(d["probes"][:4]).numpy()
    for B in (3, 5):
        wb.set_triplet_classifier_batch(d["ems"][:B], d["ens"][:B])
        x = d["probes"][:B]
        res["ebp%d" % B] = np.stack(wb.ebp_batch(x))
        res["ebp_mwp%d" % B] = np.stack(wb.ebp_batch(x, mwp=True))
        res["con1_%d" % B] = np.stack(wb.contrastive_ebp_batch(x, 20))
        con, trunc = wb.contrastive_ebp_batch_both(x, 20)
        res["con%d" % B], res["trunc%d" % B] = np.stack(con), np.stack(trunc)
        ws = wb.weighted_subtree_ebp_batch(x, topk=WS_TOPK,
                                           subtree_mode=mode)
        res["ws%d" % B] = np.stack([r[0] for r in ws])
        res["ws_sel%d" % B] = np.array(
            [r[3] + [-1] * (WS_TOPK - len(r[3])) for r in ws])
        ws = wb.weighted_subtree_ebp_batch(x, topk=WS_TOPK,
                                           subtree_mode=mode,
                                           return_subtree_maps=True)
        res["ws_host%d" % B] = np.stack([r[0] for r in ws])

    # the per-probe paths in float64: the fused and host sweeps, rows
    # over 'dp', and subtree_ebp's sweep
    wb64 = fresh(torch.float64)
    wb64.net.set_triplet_classifier(d["ems"][0].astype(np.float64),
                                    d["ens"][0].astype(np.float64))
    for path, host in (("fused", False), ("host", True)):
        smap, _, scores, ks = wb64.weighted_subtree_ebp(
            d["probe64"], 0, 1, topk=WS_TOPK, subtree_mode=mode,
            return_subtree_maps=host)
        res["ws_" + path], res["ws_%s_k" % path] = smap, np.asarray(ks)
        res["ws_%s_scores" % path] = np.asarray(scores)
    smap, scores, ks = wb64.subtree_ebp(d["probe64"], 0, 1, topk=2)
    res["subtree"], res["subtree_k"] = smap, np.asarray(ks)

    orig, inp = d["orig"], d["inp"]
    res["counts"] = wb.launch_blend_embeddings_counts(
        orig, inp, d["counts"], MESH_T)()
    res["counts_multi"] = wb.launch_blend_embeddings_counts_multi(
        orig, inp, d["counts_multi"], MESH_T_MULTI)()
    res["blend_general"] = wb.launch_blend_embeddings(orig, inp,
                                                      d["masks_general"])()
    try:
        wb.launch_blend_embeddings_counts_multi_pair(
            [orig], [inp], d["counts_multi"], np.zeros(3, np.int32),
            MESH_T_MULTI)
        res["multi_pair_refused"] = np.asarray(False)
    except ValueError:
        res["multi_pair_refused"] = np.asarray(True)

    batch = TwinClsBatch(wb, orig, inp, d["gal_o"], d["gal_i"],
                         "percent-density", percentiles=d["pct"], seed=0)
    fins = [batch.launch(s) for s in d["smaps"]]
    batch.flush()
    for i, fin in enumerate(fins):
        cls, pg, pr = fin()
        res["twin_cls%d" % i] = np.asarray(cls)
        res["twin_pg%d" % i], res["twin_pr%d" % i] = pg, pr

    for name, fused_blend in (("scan", False), ("k1", True)):
        st = _strise_injected(mesh_strise(fresh(), d, mesh,
                                          use_pallas_blend=fused_blend), d)
        res["st_%s_ref" % name] = st.masked_probe_ref_scores
        res["st_%s_scores" % name] = st.mask_scores
        res["st_%s_map" % name] = st.saliency_map
    st = _strise_injected(mesh_strise(fresh(), d, mesh), d,
                          fused_finish=True)
    res["st_fused_scores"], res["st_fused_map"] = (st.mask_scores,
                                                   st.saliency_map)
    st = mesh_strise(fresh(), d, mesh, use_pallas_blend=True, seed=9)
    st.evaluate()
    res["st_drawn_scores"], res["st_drawn_map"] = (st.mask_scores,
                                                   st.saliency_map)
    return res


def mesh_entry_worker(rank, world, init_file, data, out_dir):
    """One rank of a gloo group of ``world``: a (world, 1) mesh, every
    entry point of mesh_entry_results, written to ``out_dir/rank<r>.npz``;
    then the mesh helpers and a STRise whose ranks draw different masks
    (seed = rank), which every rank must refuse."""
    import torch.distributed as dist

    from xfr_torch.parallel import distributed as D
    from xfr_torch.parallel import mesh as M

    D.initialize("file://" + init_file, world, rank)
    mesh = M.make_mesh()
    res = mesh_entry_results(data, mesh)

    # the helpers: this rank's rows, their gather in rank order with the
    # pad rows dropped (bool as well), the flag and checksum collectives
    lo, hi = M.local_rows(mesh, 7)
    rows = torch.arange(7 * 2, dtype=torch.float64).reshape(7, 2)
    pad = torch.cat([rows, rows.new_full((hi * world - 7, 2), -1.0)])
    res["local_rows"] = np.asarray([lo, hi])
    res["gathered"] = M.gather_rows(mesh, pad[lo:hi], 7).numpy()
    res["gathered_bool"] = M.gather_rows(
        mesh, torch.tensor([rank % 2 == 0])).numpy()
    res["all_true"] = np.asarray([M.all_true(mesh, True),
                                  M.all_true(mesh, rank != 1)])
    res["all_equal"] = np.asarray([M.all_equal(mesh, 7)[0],
                                   M.all_equal(mesh, rank)[0]])
    rep = M.replicate(mesh, {"a": {"w": torch.full((3,), float(rank))}},
                      device="meta")
    res["replicate_meta"] = np.asarray(rep["a"]["w"].device.type == "meta")
    res["replicated"] = M.replicate(
        mesh, {"a": {"w": torch.full((3,), float(rank))}})["a"]["w"].numpy()
    params, d = load_params(data)
    st = mesh_strise(toy_whitebox(params, int(d["num_classes"]),
                                  str(d["mode"])), d, mesh,
                     use_pallas_blend=True, seed=rank)
    try:
        st.evaluate()
        res["draws_refused"] = np.asarray(False)
    except RuntimeError as e:
        res["draws_refused"] = np.asarray("different masks" in str(e))
    np.savez(os.path.join(out_dir, "rank%d.npz" % rank), **res)
    dist.destroy_process_group()


MESH_CLI_METHODS = ["meanEBP_mode=all_v06_cpu",
                    "contrastive_triplet_ebp_mode=all_v06_cpu",
                    "weighted_subtree_triplet_ebp_mode=all,all_v06_top32_cpu",
                    "inpaintingMask"]


def mesh_cli_worker(rank, world, init_file, params_npz, data_dir, out):
    """One rank of a gloo group running the generation CLIs on the toy net
    (the factory patched; the dataset's net is "resnetv4_pytorch") with
    --mesh auto and --mesh off, each rank into its own directories
    ``out/<run>/rank<r>``: the whitebox CLI batched and serial, the
    blackbox CLI, then run_eval under --mesh auto on rank 0's whitebox
    maps."""
    import torch.distributed as dist

    import xfr_torch.models
    from xfr_torch.cli import generate_bb_saliency, generate_wb_saliency
    from xfr_torch.cli import run_eval
    from xfr_torch.parallel import distributed as D

    D.initialize("file://" + init_file, world, rank)
    params, d = load_params(params_npz)
    xfr_torch.models.create_wbnet = lambda name, **kw: toy_whitebox(
        params, int(d["num_classes"]), str(d["mode"]))

    def run_dir(name):
        return os.path.join(out, name, "rank%d" % rank)

    common = ["--net", "resnetv4_pytorch", "--data-dir", data_dir]
    for mesh in ("auto", "off"):
        for batch in ("8", "0"):
            generate_wb_saliency.main(common + [
                "--batch-size", batch, "--mesh", mesh,
                "--saliency-dir", run_dir("wb%s_%s" % (batch, mesh))])
        generate_bb_saliency.main(common + [
            "--num-masks", "64", "--mesh", mesh,
            "--saliency-dir", run_dir("bb_" + mesh)])
    dist.barrier()  # rank 0's maps are all written
    run_eval.main(common + [
        "--saliency-dir", os.path.join(out, "wb8_auto", "rank0"),
        "--cache-dir", run_dir("cache_auto"), "--output", run_dir("eval_auto"),
        "--mask", "2", "5", "--seed", "7", "--mesh", "auto",
        "--method"] + MESH_CLI_METHODS)
    dist.destroy_process_group()
