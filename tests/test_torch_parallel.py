"""The port's triplet loader and multi-process coordination against the
JAX package's (tests/test_data_parallel.py:68-126, tests/test_cache.py:
83-95, tests/test_distributed.py on the port), and one 2-process gloo
group through the port's distributed and mesh helpers and the CLIs'
shard resolution."""

import argparse
import json
import os

import numpy as np
import PIL.Image
import pytest
import torch

from tests.torch_fixtures import spawn_ranks


def _img(seed=0, size=(64, 64)):
    rng = np.random.RandomState(seed)
    return PIL.Image.fromarray(
        (rng.rand(size[1], size[0], 3) * 255).astype(np.uint8))


@pytest.fixture
def triplet_csv(tmp_path):
    """One probe and two refs of subject 1, mask 2 (filtered.csv), and
    the probe with one ref (filtered_one_ref.csv)."""
    import pandas as pd

    root = str(tmp_path)
    rows = []
    for i, (trip, base) in enumerate((("PROBE", "p"), ("REF", "r0"),
                                      ("REF", "r1"))):
        orig = "im_%s_orig.png" % base
        inp = "im_%s_inp.png" % base
        _img(2 * i).save(os.path.join(root, orig))
        _img(2 * i + 1).save(os.path.join(root, inp))
        rows.append({"SUBJECT_ID": 1, "MASK_ID": 2, "TRIPLET_SET": trip,
                     "OriginalFile": orig, "InpaintingFile": inp})
    pd.DataFrame(rows).to_csv(os.path.join(root, "filtered.csv"),
                              index=False)
    pd.DataFrame(rows[:2]).to_csv(os.path.join(root, "filtered_one_ref.csv"),
                                  index=False)
    return root


def _loaders(root, csv, **kw):
    from xfr_torch.data import TripletDataLoader as T
    from xfr_tpu.data.triplet import TripletDataLoader as J

    path = os.path.join(root, csv)
    return (T(path, data_root=root, **kw.get("torch", {})),
            J(path, data_root=root, **kw.get("jax", {})))


@pytest.mark.parametrize("csv,refs", [("filtered.csv", 2),
                                      ("filtered_one_ref.csv", 1)])
def test_triplet_loader_matches_jax(triplet_csv, csv, refs):
    """No transform: [1,H,W,3] probe and [refs,H,W,3] stacks, equal to
    the JAX loader's; a single REF row (a Series under MultiIndex .loc)
    still iterates; file info and shuffle."""
    t, j = _loaders(triplet_csv, csv, torch={"return_file_info": True},
                    jax={"return_file_info": True})
    assert len(t) == len(j) == 1
    got, want = t[0], j[0]
    assert got[0].shape == (1, 64, 64, 3)
    assert got[1].shape == got[2].shape == (refs, 64, 64, 3)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    assert got[3].equals(want[3])
    t.shuffle()
    assert len(t) == 1


def test_triplet_loader_tensor_transform_matches_jax(triplet_csv):
    """The port's preprocess_resnet101 returns a [1,3,224,224] tensor: the
    loader keeps its batch axis and concatenates tensors, bit-equal to
    the JAX loader under the JAX preprocess; a [C,H,W] tensor gains the
    axis."""
    from xfr_torch.models.resnet101 import preprocess_resnet101 as TP
    from xfr_tpu.models.resnet101 import preprocess_resnet101 as JP

    t, j = _loaders(triplet_csv, "filtered.csv",
                    torch={"transform": lambda im: TP(im, device="cpu")},
                    jax={"transform": lambda im: JP(np.asarray(im))})
    got, want = t[0], j[0]
    assert torch.is_tensor(got[0]) and got[0].shape == (1, 3, 224, 224)
    assert got[1].shape == got[2].shape == (2, 3, 224, 224)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    t3, _ = _loaders(triplet_csv, "filtered.csv",
                     torch={"transform": lambda im: TP(im, device="cpu")[0]})
    probe, mates, _ = t3[0]
    assert probe.shape == (1, 3, 224, 224) and mates.shape == (2, 3, 224, 224)


@pytest.mark.parametrize("n,shards,shuffle,seed", [
    (17, 4, False, 0), (17, 4, True, 7), (10, 2, True, 7), (5, 8, True, 3),
    (0, 3, False, 0)])
def test_partition_jobs_matches_jax(n, shards, shuffle, seed):
    """The same lists as the JAX package's, element for element; disjoint
    shards covering the jobs, within one of each other in size."""
    from xfr_torch.parallel.distributed import partition_jobs as T
    from xfr_tpu.parallel.distributed import partition_jobs as J

    jobs = ["job%d" % i for i in range(n)]
    got = [T(jobs, i, shards, shuffle=shuffle, seed=seed)
           for i in range(shards)]
    assert got == [J(jobs, i, shards, shuffle=shuffle, seed=seed)
                   for i in range(shards)]
    assert sorted(sum(got, [])) == sorted(jobs)
    assert max(map(len, got)) - min(map(len, got)) <= 1
    # no group and no shard arguments: process 0 of 1
    assert T(jobs, shuffle=shuffle, seed=seed) == \
        J(jobs, 0, 1, shuffle=shuffle, seed=seed)


def test_single_process_defaults():
    """Without a process group: rank 0 of 1, primary, no mesh from
    auto_mesh, initialize a no-op, the whole job list, and the CLIs'
    resolve_shards at (0, 1) or their arguments."""
    import torch.distributed as dist

    from xfr_torch.cli.generate_wb_saliency import resolve_shards
    from xfr_torch.parallel import distributed as D
    from xfr_torch.parallel.mesh import auto_mesh, mesh_key

    D.initialize()
    D.initialize(num_processes=1)
    assert not dist.is_initialized()
    assert D.process_info() == (0, 1) and D.is_primary()
    assert D.partition_jobs(range(5)) == list(range(5))
    assert auto_mesh() is None and mesh_key(None) is None
    ns = argparse.Namespace
    assert resolve_shards(ns(shard_index=None, num_shards=None)) == (0, 1)
    assert resolve_shards(ns(shard_index=2, num_shards=None)) == (2, 1)
    assert resolve_shards(ns(shard_index=None, num_shards=3)) == (0, 3)


def test_barrier_rejects_stale_markers(tmp_path):
    """barrier_via_files: same-tag reuse within a run is generation-
    namespaced; a marker left by a previous run raises instead of
    silently satisfying the barrier (tests/test_cache.py:83-95)."""
    from xfr_torch.parallel.distributed import _BARRIER_GEN, barrier_via_files

    _BARRIER_GEN.clear()
    barrier_via_files(str(tmp_path), "sync", timeout_s=5)
    barrier_via_files(str(tmp_path), "sync", timeout_s=5)  # gen 2: fine
    assert sorted(os.listdir(tmp_path)) == ["sync.g1.0", "sync.g2.0"]
    _BARRIER_GEN.clear()  # a fresh run against the same directory
    with pytest.raises(RuntimeError, match="stale barrier marker"):
        barrier_via_files(str(tmp_path), "sync", timeout_s=5)
    _BARRIER_GEN.clear()


def test_two_process_gloo_group(tmp_path):
    """Two processes in a gloo group (file:// rendezvous): rank and world
    size from process_info, an all-reduce, partition_jobs and the CLIs'
    resolve_shards by rank, the mesh helpers (zero-padded shard_batch,
    the classifier's row split, replicate from rank 0, DTensor
    placements, mesh_key) and the file barrier."""
    from xfr_tpu.parallel.distributed import partition_jobs as J

    out = tmp_path / "out"
    out.mkdir()
    spawn_ranks("distributed_smoke_worker", 2, tmp_path, str(out),
                timeout=180)
    recs = [json.load(open(out / ("rank%d.json" % r))) for r in range(2)]
    for r, rec in enumerate(recs):
        assert rec["sum"] == 3.0
        assert rec["jobs"] == J(list(range(10)), r, 2, shuffle=True, seed=7)
        assert rec["resolve"] == [r, 2]
        assert rec["resolve_explicit"] == [1, 1]
        assert rec["primary"] == (r == 0)
        assert rec["mesh_key"] == [[["dp", 2], ["mp", 1]], [0, 1]]
        assert rec["n"] == 5
        # 5 rows padded with one zero row to 6, 3 a rank
        want = np.vstack([np.arange(15.0).reshape(5, 3), np.zeros((1, 3))])
        np.testing.assert_array_equal(rec["rows"], want[3 * r:3 * r + 3])
        # 7 classes over mp=2: torch.chunk's split, 4 and 3 rows
        lo, hi = (0, 4) if r == 0 else (4, 7)
        assert rec["sharding"]["fc2"] == {"w": [lo, hi], "b": [lo, hi]}
        assert rec["sharding"]["fc1"] == {"w": [None, None]}
        assert rec["replicated"] == [0.0, 0.0, 0.0]
        assert rec["placements"] == ["S(0)", "R"]
    assert sorted(sum((rec["jobs"] for rec in recs), [])) == list(range(10))
    assert sorted(os.listdir(out)) == ["done.g1.0", "done.g1.1",
                                       "rank0.json", "rank1.json"]
