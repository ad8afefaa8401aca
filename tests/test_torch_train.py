"""The port's fine-tuning step against the JAX package's
(xfr_tpu/train/finetune.py; tests/test_sharding.py:175-262 on the port).

Both packages run the same float64 weights and batches on the CPU.  A
parameter is compared by its distance from JAX's after the steps, over
the largest change JAX's steps made to it: LEAF_TOL of that change (the
float64 runs read 2.2e-14 at most on the toy net and on reduced
ResNet-101).  Losses at rtol LOSS_RTOL (read: 3.5e-16 relative)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.fixtures import make_toy_wbnet
from tests.torch_fixtures import (jax_params_np, load_params, save_params,
                                  spawn_ranks, toy_graph, twin_graph)
from xfr_torch.models.convert import params_from_jax

LEAF_TOL = 1e-9
LOSS_RTOL = 1e-12


def _toy(num_classes=8, seed=3):
    """The toy net's JAX graph, float64 params, and the port's graph."""
    wb = make_toy_wbnet(num_classes=num_classes, seed=seed)
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                          wb.net.params)
    g, _, out = toy_graph()
    return wb.net.graph, params, g.finalize(out)


def _batch(n=8, classes=8, seed=3):
    rng = np.random.RandomState(seed)
    return rng.rand(n, 3, 224, 224) * 50, (np.arange(n) % classes)


def _jax_steps(graph, params, x, y, steps, **kw):
    from xfr_tpu.train.finetune import make_train_step

    step, init = make_train_step(graph, "fc2", **kw)
    p, o = init(params)
    losses = []
    for _ in range(steps):
        p, o, loss = step(p, o, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(loss))
    return p, losses


def _torch_steps(graph, params, x, y, steps, **kw):
    from xfr_torch.train.finetune import make_train_step

    step, init = make_train_step(graph, "fc2", device="cpu", **kw)
    p, o = init(params_from_jax(jax_params_np(params), device="cpu"))
    losses = []
    for _ in range(steps):
        p, o, loss = step(p, o, torch.from_numpy(x), torch.from_numpy(y))
        losses.append(float(loss))
    return p, losses


def _assert_leaves_match(got, want, start):
    """Every leaf of ``got`` (torch or numpy) within LEAF_TOL of the
    largest change JAX made to it; a leaf JAX left alone is bit-equal."""
    assert got.keys() == want.keys()
    for pname in want:
        assert got[pname].keys() == want[pname].keys()
        for k in want[pname]:
            a = got[pname][k]
            a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
            b, b0 = np.asarray(want[pname][k]), np.asarray(start[pname][k])
            moved = np.abs(b - b0).max()
            if moved == 0:
                np.testing.assert_array_equal(a, b, err_msg=(pname, k))
            else:
                assert np.abs(a - b).max() <= LEAF_TOL * moved, (pname, k)


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_sgd_matches_optax(weight_decay):
    """torch.optim.SGD(momentum=0.9) after wd * param is added to the
    gradient is optax.sgd(momentum=0.9) chained after
    add_decayed_weights(wd): 3 steps in float64, same gradients, equal to
    1e-15 of the parameters' scale."""
    import optax

    rng = np.random.RandomState(0)
    p0 = rng.randn(5, 4)
    grads = [rng.randn(5, 4) for _ in range(3)]
    tx = optax.sgd(0.1, momentum=0.9)
    if weight_decay:
        tx = optax.chain(optax.add_decayed_weights(weight_decay), tx)
    pj = jnp.asarray(p0)
    state = tx.init(pj)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, pj)
        pj = optax.apply_updates(pj, upd)

    # the decay as make_train_step adds it, then the default optimizer
    pt = torch.tensor(p0, requires_grad=True)
    opt = torch.optim.SGD([pt], lr=0.1, momentum=0.9)
    for g in grads:
        opt.zero_grad()
        pt.grad = torch.from_numpy(g).clone()
        pt.grad.add_(pt.detach(), alpha=weight_decay)
        opt.step()
    np.testing.assert_allclose(pt.detach().numpy(), np.asarray(pj), rtol=0,
                               atol=1e-15 * np.abs(p0).max())


@pytest.mark.parametrize("kw", [
    {}, {"weight_decay": 1e-2}, {"weight_decay": 1e-2, "train_bn_stats": True},
    {"learning_rate": 1e-2}], ids=["plain", "wd", "wd_bn_stats", "lr"])
def test_train_step_toy_matches_jax(kw):
    """3 steps on the toy net (conv, BN, pools, L2 norm, 8 classes), B=8:
    the losses and every leaf equal JAX's make_train_step.  With
    train_bn_stats the BN statistics move exactly as JAX moves them;
    without it they stay bit-identical."""
    jgraph, params, tgraph = _toy()
    x, y = _batch()
    pj, lj = _jax_steps(jgraph, params, x, y, 3, **kw)
    pt, lt = _torch_steps(tgraph, params, x, y, 3, **kw)
    np.testing.assert_allclose(lt, lj, rtol=LOSS_RTOL)
    _assert_leaves_match(pt, pj, params)
    moved = [not np.array_equal(np.asarray(pj["bn1"][k]),
                                np.asarray(params["bn1"][k]))
             for k in ("mean", "var")]
    assert all(moved) == bool(kw.get("train_bn_stats"))


def test_train_step_reduced_resnet101_matches_jax():
    """ResNet-101+L2 at one block a stage, 16 classes, B=2, weight decay:
    3 steps equal JAX's (run un-jitted, so no whole-graph compile)."""
    from xfr_tpu.models import common as JC
    from xfr_tpu.models import resnet101 as JR

    graph, shapes, _ = JR.build_resnet101(num_classes=16, layers=(1, 1, 1, 1))
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                          JC.init_params(shapes, seed=2))
    rng = np.random.RandomState(0)
    x, y = rng.rand(2, 3, 224, 224) * 50, np.array([3, 11])
    with jax.disable_jit():
        pj, lj = _jax_steps(graph, params, x, y, 3, weight_decay=1e-2)
    pt, lt = _torch_steps(twin_graph(graph), params, x, y, 3,
                          weight_decay=1e-2)
    np.testing.assert_allclose(lt, lj, rtol=LOSS_RTOL)
    _assert_leaves_match(pt, pj, params)


def test_train_step_freezes_bn_stats_by_default():
    """tests/test_sharding.py:214-262 on the port: the default step leaves
    the BN statistics bit-identical over two steps (also under weight
    decay) while the weights move; train_bn_stats=True moves them.  The
    frozen leaves carry no gradient and are not in the optimizer."""
    from xfr_torch.train.finetune import make_train_step

    _, params, graph = _toy()
    net = params_from_jax(jax_params_np(params), device="cpu")
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(4, 3, 224, 224) * 50)
    y = torch.from_numpy(np.arange(4) % 8)
    bn_keys = [(p, k) for p, lv in net.items() for k in lv
               if k in ("mean", "var")]
    assert bn_keys

    for kw in ({}, {"weight_decay": 1e-2}):
        step, init = make_train_step(graph, "fc2", device="cpu", **kw)
        p, o = init(net)
        trained = {id(v) for g in o.param_groups for v in g["params"]}
        for pn, k in bn_keys:
            assert not p[pn][k].requires_grad and id(p[pn][k]) not in trained
        p, o, loss0 = step(p, o, x, y)
        p, o, loss1 = step(p, o, x, y)
        for pn, k in bn_keys:
            assert p[pn][k].grad is None
            torch.testing.assert_close(p[pn][k], net[pn][k], rtol=0, atol=0)
        assert any(not torch.equal(p[pn]["w"], net[pn]["w"])
                   for pn, lv in net.items() if "w" in lv)
        assert np.isfinite(float(loss0)) and np.isfinite(float(loss1))

    step2, init2 = make_train_step(graph, "fc2", device="cpu",
                                   train_bn_stats=True)
    p2, o2 = init2(net)
    p2, o2, _ = step2(p2, o2, x, y)
    assert any(not torch.equal(p2[pn][k], net[pn][k]) for pn, k in bn_keys)


def test_eval_step_matches_jax():
    """make_eval_step's mean loss and top-1 hits equal JAX's, on the
    starting weights and after one training step."""
    from xfr_tpu.train.finetune import make_eval_step as JE
    from xfr_torch.train.finetune import make_eval_step as TE

    jgraph, params, tgraph = _toy()
    x, y = _batch()
    pj, _ = _jax_steps(jgraph, params, x, y, 1)
    pt, _ = _torch_steps(tgraph, params, x, y, 1)
    for p_j, p_t in ((params, params_from_jax(jax_params_np(params),
                                              device="cpu")), (pj, pt)):
        lj, hj = JE(jgraph)(p_j, jnp.asarray(x), jnp.asarray(y))
        lt, ht = TE(tgraph, device="cpu")(p_t, torch.from_numpy(x),
                                          torch.from_numpy(y))
        np.testing.assert_allclose(float(lt), float(lj), rtol=LOSS_RTOL)
        assert int(ht) == int(hj)


def test_mesh_train_and_eval_step_match_jax(tmp_path):
    """A 2x2 (dp, mp) mesh of four gloo processes: the batch split over dp,
    fc2's 8 rows over mp.  After 3 weight-decayed steps every rank's trunk
    and its fc2 rows, the losses, and the eval step's loss and hits equal
    JAX's single-device step (tests/test_sharding.py:175-211)."""
    jgraph, params, _ = _toy()
    x, y = _batch()
    kw = {"weight_decay": 1e-2, "learning_rate": 1e-2}
    pj, lj = _jax_steps(jgraph, params, x, y, 3, **kw)
    from xfr_tpu.train.finetune import make_eval_step

    ej, hj = make_eval_step(jgraph)(pj, jnp.asarray(x), jnp.asarray(y))

    data = str(tmp_path / "data.npz")
    save_params(data, jax_params_np(params), x=x, y=y)
    out = tmp_path / "out"
    out.mkdir()
    spawn_ranks("mesh_train_worker", 4, tmp_path, data, str(out), 3,
                kw["weight_decay"], kw["learning_rate"], timeout=240)
    fc2 = {}
    for r in range(4):
        pt, rec = load_params(str(out / ("rank%d.npz" % r)))
        np.testing.assert_allclose(rec["losses"], lj, rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(rec["eval_loss"]), float(ej),
                                   rtol=LOSS_RTOL)
        assert int(rec["hits"]) == int(hj)
        fc2.setdefault(int(rec["dp"]), {})[int(rec["mp"])] = pt["fc2"]["w"]
        pt["fc2"] = {"w": pj["fc2"]["w"]}
        _assert_leaves_match(pt, pj, params)
    for d in (0, 1):
        assert fc2[d][0].shape == (4, 12) and fc2[d][1].shape == (4, 12)
        _assert_leaves_match({"fc2": {"w": torch.cat([fc2[d][0], fc2[d][1]])}},
                             {"fc2": pj["fc2"]}, {"fc2": params["fc2"]})


def test_forward_values_carries_grad_and_forward_clean_does_not():
    """The trainer's forward records autograd; forward_clean, which every
    EBP caller uses, stays no-grad with the same values."""
    from xfr_torch.ebp import interpreter as I

    _, params, graph = _toy()
    p = params_from_jax(jax_params_np(params), device="cpu")
    for v in p["fc1"].values():
        v.requires_grad_(True)
    x = torch.from_numpy(_batch(2)[0])
    out = I.forward_values(graph, p, x)[graph.output_id]
    clean = I.forward_clean(graph, p, x)[graph.output_id]
    assert out.requires_grad and not clean.requires_grad
    torch.testing.assert_close(out.detach(), clean, rtol=0, atol=0)
    kept = I.forward_clean(graph, p, x, keep=[graph.output_id])
    torch.testing.assert_close(kept[graph.output_id], clean, rtol=0, atol=0)


def test_trainer_needs_a_card_unless_cpu_is_asked():
    """The default device is the card: without one, both steps raise."""
    from xfr_torch.train.finetune import make_eval_step, make_train_step

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    _, _, graph = _toy()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(graph, "fc2")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_eval_step(graph)
