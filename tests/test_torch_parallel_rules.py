"""The port's multi-device rules without processes: the tensor-parallel and
ZeRO-1 shard dims against yolojax's ``param_shardings`` and
``opt_state_shardings`` on Darknet-19's and tiny v2's shapes (HWIO/(in,
out) dims mapped to the port's OIHW/(out, in)), the mesh's refusals in
yolojax's words, the process-group settings, and the global-batch draws
(augmentation and dropout) that a data rank cuts its rows from."""

import dataclasses

import numpy as np
import pytest
import torch

from yolojax_torch.data import augment
from yolojax_torch.models import get_model
from yolojax_torch.nn.layers import DropoutSpec, Network, weight_shapes
from yolojax_torch.parallel import distributed
from yolojax_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    mesh_rows,
    opt_state_shard_dims,
    param_shard_dims,
    shard_batch,
    zero_dims,
)
from yolojax_torch.parallel.sharding import Plan
from yolojax_torch.train import step
from yolojax_torch.train.checkpoint import Checkpointer

# yolojax's HWIO dim j is the port's OIHW dim _HWIO[j]; (in, out) -> (out, in)
_HWIO, _DENSE = (2, 3, 1, 0), (1, 0)


def _port_shapes(name: str, inference: str, dim: int):
    """{port param name: shape} of the model's params, without weights."""
    model = get_model(name, inference, 20)
    shapes = {}
    for conv, w in weight_shapes(model.specs, 3, (dim, dim)).items():
        shapes[f"{conv}.w"] = w
        spec = model.specs[int(conv.split("_")[1])]
        keys = ("scale", "bias") if getattr(spec, "bn", False) else ("b",)
        for k in keys:
            shapes[f"{conv}.{k}"] = (w[0],)
    return shapes


def _jax_tree(shapes):
    """The yolojax params tree of the same shapes (zero-stride arrays)."""
    tree = {}
    for full, shape in shapes.items():
        layer, key = full.split(".")
        if len(shape) == 4:
            shape = tuple(shape[j] for j in (2, 3, 1, 0))  # OIHW -> HWIO
        elif len(shape) == 2:
            shape = (shape[1], shape[0])
        tree.setdefault(layer, {})[key] = np.broadcast_to(np.float32(0),
                                                          shape)
    return tree


def _axis_dims(spec, ndim):
    """{axis name: yolojax dim} of a PartitionSpec."""
    out = {}
    for d, entry in enumerate(tuple(spec) + (None,) * ndim):
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None:
                out[axis] = d
    return out


def _to_port(d, ndim):
    if d is None:
        return None
    return {4: _HWIO, 2: _DENSE}.get(ndim, tuple(range(ndim)))[d]


@pytest.mark.parametrize("model_ax", [1, 2])
@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("arch", [("yolo2", "darknet", 416),
                                  ("yolo2", "tiny", 416)],
                         ids=["darknet19", "tiny_v2"])
def test_shard_rules_match_yolojax(arch, dp, model_ax):
    from yolojax.parallel.mesh import (
        make_mesh as jax_make_mesh,
        opt_state_shardings,
        param_shardings,
    )

    shapes = _port_shapes(*arch)
    tree = _jax_tree(shapes)
    mesh = jax_make_mesh(data=dp, model=model_ax)
    p_spec = param_shardings(mesh, tree)
    o_spec = opt_state_shardings(mesh, tree)
    tp = param_shard_dims(shapes, model_ax)
    zd = opt_state_shard_dims({"trace": shapes, "count": 0}, dp, model_ax)
    assert zd["count"] == (None, None)
    n_tp = n_zero = n_both = 0
    for full, shape in shapes.items():
        layer, key = full.split(".")
        nd = len(shape)
        want_p = _axis_dims(p_spec[layer][key].spec, nd)
        assert tp[full] == _to_port(want_p.get("model"), nd), full
        want_o = _axis_dims(o_spec[layer][key].spec, nd)
        got = zd["trace"][full]
        assert got == (_to_port(want_o.get("model"), nd),
                       _to_port(want_o.get("data"), nd)), (full, got, want_o)
        n_tp += tp[full] is not None
        n_zero += got[1] is not None
        n_both += got[0] is not None and got[0] == got[1]
    assert n_zero > 0
    assert (n_tp > 0) == (model_ax > 1)
    # the BN vectors of a TP conv take both axes on their one dim
    assert (n_both > 0) == (model_ax > 1)


def test_zero_rule_ties_break_on_yolojax_axis():
    """HWIO (3, 3, 1024, 1024): yolojax's stable sort takes the input axis
    (HWIO dim 2) of two equal ones, which is OIHW dim 1 - not dim 0."""
    assert zero_dims((1024, 1024, 3, 3), 2, 1) == (None, 1)
    assert zero_dims((1024, 1024, 3, 3), 2, 2) == (0, 1)
    assert zero_dims((125, 1024, 1, 1), 4, 1) == (None, 1)
    assert zero_dims((1024,), 2, 2) == (0, 0)       # both axes on one dim
    assert zero_dims((30,), 4, 1) == (None, None)   # indivisible: replicated
    assert zero_dims((), 2, 1) == (None, None)      # scalars replicate


@pytest.mark.parametrize("data,model,world,match", [
    (2, 1, 1, "mesh 2x1 needs data\\*model = 2 devices, have 1"),
    (None, 2, 1, "1 devices not divisible by model=2"),
    (2, 2, 2, "mesh 2x2 needs data\\*model = 4 devices, have 2"),
    (1, 1, 2, "mesh 1x1 uses 1 of 2 processes"),
])
def test_make_mesh_refuses_like_yolojax(data, model, world, match):
    with pytest.raises(ValueError, match=match):
        make_mesh(data=data, model=model, world=world)


def test_one_process_mesh_and_settings(monkeypatch):
    """No group: a 1x1 mesh with no groups; the settings that do not make
    a multi-process run (no coordinator, one process) make no group, and a
    multi-process one without an id is refused with yolojax's text."""
    mesh = make_mesh()
    assert (mesh.shape, mesh.size, mesh.data_group) == (
        {"data": 1, "model": 1}, 1, None)
    for var in ("JAX_COORDINATOR", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert not distributed.maybe_initialize("", 2, 0)
    assert not distributed.maybe_initialize("127.0.0.1:1", 1, 0)
    assert not distributed.maybe_initialize()
    with pytest.raises(ValueError, match="needs process_id"):
        distributed.maybe_initialize("127.0.0.1:1", 2)
    monkeypatch.setenv("JAX_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="needs process_id"):
        distributed.maybe_initialize()
    assert distributed.process_index() == 0
    assert distributed.process_count() == 1


def test_rows_of_the_global_batch():
    batch = tuple(torch.arange(8 * k).reshape(8, k) for k in (1, 2))
    for rank in range(4):
        mesh = Mesh(4, 1, rank=rank)
        assert mesh_rows(mesh, 2) == (2 * rank, 8)
        got = shard_batch(mesh, batch)
        for g, b in zip(got, batch):
            assert torch.equal(g, b[2 * rank: 2 * rank + 2])
    assert mesh_rows(Mesh(1, 2, rank=1), 8) is None
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(Mesh(3, 1), batch)


@pytest.mark.parametrize("rank", [0, 1, 2])
def test_augment_draws_are_the_global_batchs(rank):
    """A data rank's augmentation of its rows is those rows of the one
    device's augmentation of the global batch (same seed)."""
    n, total = 2, 6
    rng = np.random.RandomState(3)
    images = torch.from_numpy(rng.uniform(0, 1, (total, 40, 40, 3))
                              .astype(np.float32))
    boxes = torch.tensor([[0.5, 0.5, 0.3, 0.4]]).expand(total, 1, 4)
    valid = torch.ones((total, 1), dtype=torch.bool)
    full = augment.augment_batch(torch.Generator().manual_seed(7), images,
                                 boxes, valid, 32)
    rows = slice(rank * n, rank * n + n)
    part = augment.augment_batch(torch.Generator().manual_seed(7),
                                 images[rows], boxes[rows], valid[rows], 32,
                                 rows=(rank * n, total))
    for a, b in zip(part, full):
        assert torch.equal(a, b[rows])


@pytest.mark.parametrize("rank", [0, 1])
def test_dropout_mask_is_the_global_batchs(rank):
    net = Network((DropoutSpec(0.5),), {})
    x = torch.rand((6, 5, 5, 4), generator=torch.Generator().manual_seed(1))
    kw = dict(compute_dtype=torch.float32, train=True)
    full, _ = net(x, generator=torch.Generator().manual_seed(4), **kw)
    rows = slice(3 * rank, 3 * rank + 3)
    part, _ = net(x[rows], generator=torch.Generator().manual_seed(4),
                  mesh=Mesh(2, 1, rank=rank), **kw)
    assert torch.equal(part, full[rows])


def test_plan_pieces_and_layout_on_one_process():
    """The pieces a rank keeps, without collectives: TP cuts the 1024-wide
    convs (kernel, BN parameters and running statistics) on dim 0, ZeRO-1
    the optimizer buffers on the rule's dim; ``full_shapes`` is the
    one-device checkpoint layout and ``load`` cuts a full payload alike."""
    model = get_model("yolo2", "tiny", 20)
    tx = step.make_optimizer(step.OptimizerConfig(optimizer="momentum",
                                                  ema_decay=0.9))
    full = step.init_train_state(model, tx, torch.Generator().manual_seed(0),
                                 64)
    ref = {"params": {k: v.detach().clone()
                      for k, v in full.net.named_parameters()},
           "bn_state": {k: v.clone() for k, v in full.net.named_buffers()
                        if k.endswith((".mean", ".var"))},
           "opt_state": {k: ({kk: vv.clone() for kk, vv in v.items()}
                             if isinstance(v, dict) else v)
                         for k, v in full.opt_state.items()},
           "step": 0}
    want_layout = {k: tuple(v.shape) for k, v in ref["params"].items()}
    for rank in range(4):
        ts = step.init_train_state(model, tx,
                                   torch.Generator().manual_seed(0), 64)
        plan = Plan(Mesh(2, 2, rank=rank), zero=True)
        plan.shard(ts)
        wide = [k for k, d in plan.tp.items() if d is not None]
        assert {k.split(".")[1] for k in wide} == {"w", "scale", "bias",
                                                  "mean", "var"}
        m, d = rank % 2, rank // 2
        for k, p in ts.net.named_parameters():
            want = ref["params"][k]
            if plan.tp[k] is not None:
                want = want.chunk(2)[m]
            assert torch.equal(p, want), k
            buf = ts.opt_state["trace"][k]
            dim = plan.zdims[k][1]
            assert torch.equal(ts.opt_state["ema_params"][k],
                               want if dim is None
                               else want.chunk(2, dim)[d]), k
            assert buf.numel() == want.numel() // (1 if dim is None else 2)
        assert plan.full_shapes(ts)["params"] == want_layout
        ts2 = step.init_train_state(model, tx,
                                    torch.Generator().manual_seed(1), 64)
        Plan(Mesh(2, 2, rank=rank), zero=True).shard(ts2)
        ts2.plan.load(ts2, ref)
        for k, p in ts2.net.named_parameters():
            assert torch.equal(p, ts.net.get_parameter(k)), k
        for k, b in ts.opt_state["ema_params"].items():
            assert torch.equal(ts2.opt_state["ema_params"][k], b), k


def test_non_primary_checkpointer_writes_nothing(tmp_path):
    """On a rank other than the primary a save records the step (so every
    rank decides ``should_save`` alike) and writes nothing."""
    model = get_model("yolo2", "tiny", 20)
    tx = step.make_optimizer(step.OptimizerConfig())
    ts = step.init_train_state(model, tx, torch.Generator().manual_seed(0),
                               64)
    ck = Checkpointer(str(tmp_path), save_interval_steps=2, primary=False)
    assert ck.should_save(1) and ck.save(1, ts)
    assert ck.latest_step() == 1 and ck.steps() == []
    assert not ck.should_save(3) and ck.should_save(4)
    prim = Checkpointer(str(tmp_path / "p"), save_interval_steps=2,
                        primary=True)
    assert prim.save(1, ts) and prim.steps() == [1]
    assert dataclasses.is_dataclass(ts) and ts.plan is None
