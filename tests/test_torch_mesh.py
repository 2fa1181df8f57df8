"""The port's device mesh (``ugpg_tpu_torch/parallel/mesh.py``), its ``--mesh``
grammar (``ugpg_tpu_torch/cli/__init__.py::parse_mesh``) and ``serve``'s
buckets, on the CPU, against the JAX package's ``parallel/mesh.py`` on the
fake CPU devices of ``tests/conftest.py``.

On the CPU a port mesh names the one CPU device as often as it has
positions, as its command lines build it; where a test needs the devices
distinct, it names ``torch.device("cpu", i)``, which torch keys apart
while every tensor stays in the one CPU memory.  The TP rule is compared leaf by
leaf: a full-width stage-1 variable tree whose leaves JAX's
``param_shardings`` shards are ones and the rest zeros, carried over with
``io/from_jax.py``, must shard exactly where the port's rule does; the
int8 ``wq`` trees of both packages likewise, by path.
"""

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_models import jax_variables
from ugpg_tpu.cli.serve import resolve_buckets as jax_resolve_buckets
from ugpg_tpu.cli.train_monuseg import parse_mesh as jax_parse_mesh
from ugpg_tpu.models.folding import fold_batchnorm as jax_fold_batchnorm
from ugpg_tpu.ops.quant import quantize_weights as jax_quantize_weights
from ugpg_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ugpg_tpu.parallel.mesh import param_shardings as jax_param_shardings
from ugpg_tpu_torch.cli import parse_mesh
from ugpg_tpu_torch.cli.serve import resolve_buckets
from ugpg_tpu_torch.eval.serving import stage_model
from ugpg_tpu_torch.io.from_jax import state_dict_from_jax
from ugpg_tpu_torch.models.folding import fold_batchnorm
from ugpg_tpu_torch.ops.quant import QuantizedModel, quantize_weights
from ugpg_tpu_torch.parallel import tensor
from ugpg_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    make_mesh,
    param_shardings,
    replicated,
    shard_batch,
    shard_variables,
    tp_sharded,
)

CPU = torch.device("cpu")


def cpu_mesh(n_data, n_model=1):
    return make_mesh(n_data, n_model, devices=[CPU] * (n_data * n_model))


@pytest.mark.parametrize("n_data,n_model", [(2, 1), (4, 1), (2, 2), (1, 4), (8, 1)])
def test_make_mesh_matches_jax(n_data, n_model):
    jm = jax_make_mesh(n_data=n_data, n_model=n_model)
    pm = cpu_mesh(n_data, n_model)
    assert pm.axis_names == tuple(jm.axis_names) == ("data", "model")
    assert pm.shape == dict(jm.shape)
    assert pm.devices.shape == jm.devices.shape
    assert pm.distinct_devices() == [CPU] and pm.first == CPU
    assert pm == cpu_mesh(n_data, n_model) and hash(pm) == hash(cpu_mesh(n_data, n_model))
    assert pm != cpu_mesh(n_model, n_data) or n_data == n_model
    # n_data=None takes as many as fit
    assert make_mesh(n_model=n_model, devices=[CPU] * 8).shape["data"] == 8 // n_model
    assert batch_sharding(pm).spec == ("data",) and replicated(pm).spec == ()


def test_make_mesh_refuses_more_devices_than_given(monkeypatch):
    with pytest.raises(ValueError, match="exceeds the 2 visible device"):
        make_mesh(4, devices=[CPU, CPU])
    with pytest.raises(ValueError, match="exceeds the 8 visible"):
        jax_make_mesh(n_data=16)  # the JAX package refuses the same way
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(2)  # the visible cards, never a quiet fall back to the CPU
    mesh = Mesh(np.asarray(["cpu", "cpu"], dtype=object), ("data",))
    assert mesh.shape == {"data": 2} and mesh.device_at(data=1) == CPU


def _marked(variables, shardings):
    """``variables`` with every leaf JAX shards over 'model' set to ones
    and every other leaf to zeros."""
    flat, tree = jax.tree_util.tree_flatten(variables)
    specs = jax.tree_util.tree_leaves(shardings)
    marked = [np.ones_like(v) if "model" in tuple(s.spec) else np.zeros_like(v)
              for v, s in zip(flat, specs)]
    return jax.tree_util.tree_unflatten(tree, marked)


@pytest.mark.parametrize("stage,n_data,n_model", [(1, 2, 2), (1, 1, 4), (2, 2, 2), (1, 4, 1),
                                                   (1, 1, 3)])
def test_param_shardings_shard_the_leaves_jax_shards(stage, n_data, n_model):
    v = jax_variables(stage, width=1.0, seed=3)
    js = jax_param_shardings(v, jax_make_mesh(n_data=n_data, n_model=n_model), True)
    marks = state_dict_from_jax(_marked(v, js))
    specs = param_shardings(marks, cpu_mesh(n_data, n_model), True)
    sharded = sorted(k for k, s in specs.items() if "model" in s.spec)
    assert sharded == sorted(k for k, t in marks.items() if t.numel() and bool(t.all()))
    assert bool(sharded) == (n_model in (2, 4))  # 3 divides no width; 1 shards nothing
    for k in sharded:  # the output channels of the port's (Cout, Cin, 3, 3)
        assert specs[k].spec == ("model", None, None, None), k
    unsharded = param_shardings(marks, cpu_mesh(n_data, n_model), shard_model=False)
    assert all(s.spec == () for s in unsharded.values())


def test_param_shardings_of_int8_weights_match_jax():
    v = jax_variables(1, width=1.0, seed=4)
    scales = {k: 0.01 for k in ("in", "inc.mid", "inc.out", "down4.mid", "down4.out", "up1.up",
                                "up1.mid", "up1.out")}
    jq = jax_quantize_weights(jax_fold_batchnorm(v), 1, scales)
    pq = quantize_weights(fold_batchnorm(state_dict_from_jax(v)), 1, scales)
    js = jax_param_shardings(jq, jax_make_mesh(n_data=2, n_model=2), True)
    ps = param_shardings(pq, cpu_mesh(2, 2), True)
    for block in ("inc", "down4", "up1"):
        for conv in ("conv1", "conv2"):
            for leaf in ("wq", "scale", "bias"):
                want = tuple(js[block][conv][leaf].spec)
                assert ps[block][conv][leaf].spec == want, (block, conv, leaf)
    assert ps["inc"]["conv1"]["wq"].spec == (None, None, None, "model")  # 512 outputs
    assert ps["up1"]["conv1"]["wq"].spec == (None, None, None, "model")  # 256 outputs


def test_column_parallel_splits_the_convs_jax_shards():
    """Over a (1, 2) row of distinct devices: the float and the int8 model
    wrap exactly the convs whose weights JAX's ``param_shardings`` shards,
    each device holding its ``shard_variables`` slice of the output
    channels; the other convs run whole on the first device."""
    v = jax_variables(1, width=1.0, seed=6)
    js = jax_param_shardings(v, jax_make_mesh(n_data=1, n_model=2), True)
    marks = state_dict_from_jax(_marked(v, js))
    sharded = {k.rpartition(".")[0] for k, t in marks.items() if t.dim() == 4 and t.any()}
    assert sharded  # inc, down4 and up1 at full width
    devices = [torch.device("cpu", j) for j in range(2)]
    sd = state_dict_from_jax(v)
    model = stage_model(1, sd, CPU)
    whole = model.state_dict()
    twin = tensor.column_parallel(model, devices)
    convs = {f"{name}.conv_op.{slot}": slices for name, m in twin.named_modules()
             if isinstance(m, tensor._ColumnParallelDoubleConv)
             for slot, slices in zip((0, 3), m.convs)}
    assert {k for k, s in convs.items() if len(s) == 2} == sharded
    for key, slices in convs.items():
        if len(slices) == 2:
            assert [d for d, _ in slices] == devices
            assert torch.equal(torch.cat([w[0] for _, w in slices]), whole[f"{key}.weight"])
        else:
            assert slices[0][0] == devices[0]
    calib = [np.random.default_rng(7).random((2, 32, 32, 3), dtype=np.float32)]
    qmodel = QuantizedModel.from_state_dict(sd, 1, calib, CPU)
    qtwin = tensor.column_parallel(qmodel, devices)
    split = {name.removeprefix("blocks."): m for name, m in qtwin.named_modules()
             if isinstance(m, tensor._ColumnParallelQConv)}
    jq = jax_param_shardings(jax_quantize_weights(jax_fold_batchnorm(v), 1, dict.fromkeys(
        ("in", "inc.mid", "inc.out", "down4.mid", "down4.out", "up1.up", "up1.mid", "up1.out"),
        0.01)), jax_make_mesh(n_data=1, n_model=2), True)
    assert set(split) == {f"{b}.{c}" for b in ("inc", "down4", "up1") for c in ("conv1", "conv2")
                          if "model" in tuple(jq[b][c]["wq"].spec)}
    for name, m in split.items():
        w = qmodel.get_submodule(f"blocks.{name}").w
        assert [s[0] for s in m.slices] == devices
        assert torch.equal(torch.cat([s[1] for s in m.slices], dim=1), w)


def test_tp_rule():
    assert tp_sharded(256, 2) and tp_sharded(512, 4)
    assert not tp_sharded(128, 2) and not tp_sharded(512, 1) and not tp_sharded(512, 3)


def test_shard_variables_places_slices_and_shares_replicas():
    g = torch.Generator().manual_seed(0)
    sd = {"inc.conv.conv_op.0.weight": torch.randn(512, 3, 3, 3, generator=g),
          "inc.conv.conv_op.0.bias": torch.randn(512, generator=g),
          "up1.conv.conv_op.3.weight": torch.randn(128, 256, 3, 3, generator=g)}
    mesh = cpu_mesh(2, 2)
    placed = shard_variables(sd, mesh, shard_model=True)
    assert sorted(placed) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    w = "inc.conv.conv_op.0.weight"
    assert torch.equal(torch.cat([placed[0, 0][w], placed[0, 1][w]]), sd[w])
    assert placed[0, 0][w] is placed[1, 0][w]  # one copy per device and slice
    for name in ("inc.conv.conv_op.0.bias", "up1.conv.conv_op.3.weight"):
        assert all(placed[i][name] is sd[name] for i in placed)  # replicated, on its device
    whole = shard_variables(sd, mesh, shard_model=False)
    assert all(whole[i][w] is sd[w] for i in whole)


def test_shard_batch_splits_the_leading_axis_in_order():
    mesh = cpu_mesh(4)
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    parts = shard_batch(x, mesh)
    assert [p.shape for p in parts] == [(2, 3)] * 4
    assert torch.equal(torch.cat(parts), torch.from_numpy(x))
    pairs = shard_batch((x, x[:, 0]), mesh)
    assert [tuple(p[1].tolist()) for p in pairs] == [(0.0, 3.0), (6.0, 9.0), (12.0, 15.0),
                                                     (18.0, 21.0)]
    assert shard_batch({"a": x}, mesh)[3]["a"].shape == (2, 3)
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(x[:6], mesh)


def test_parse_mesh_grammar_matches_jax(monkeypatch):
    """'N' == 'N,1'; None -> None; junk exits with the JAX package's message;
    on the CPU the mesh repeats the CPU; under a coordinator the processes
    join first (``init_process_group`` records its call here), and without
    a process count nothing is joined."""
    for spec in ("2", "2,2", "1,4", "auto"):
        got = parse_mesh(spec, "cpu")
        want = jax_parse_mesh(spec) if spec != "auto" else None
        assert got.axis_names == ("data", "model")
        if want is not None:
            assert got.shape == dict(want.shape)
        assert got.distinct_devices() == [CPU]
    assert parse_mesh("auto", "cpu").shape == {"data": 1, "model": 1}
    assert parse_mesh(None) is None and jax_parse_mesh(None) is None
    for junk in ("1,2,3", "x"):
        with pytest.raises(SystemExit, match="DATA"):
            parse_mesh(junk, "cpu")
    with pytest.raises(SystemExit, match="DATA"):
        jax_parse_mesh("1,2,3")
    import torch.distributed as dist

    joined = []
    monkeypatch.setattr(dist, "init_process_group", lambda **kw: joined.append(kw))
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setenv("UGPG_COORDINATOR_ADDRESS", "localhost:1234")
    with pytest.raises(ValueError, match="no process count"):
        parse_mesh("2", "cpu")
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert parse_mesh("2", "cpu").shape == {"data": 2, "model": 1}
    assert [j["init_method"] for j in joined] == ["tcp://localhost:1234"]
    monkeypatch.delenv("UGPG_COORDINATOR_ADDRESS")
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        parse_mesh("2")


def test_serve_resolve_buckets_matches_jax():
    jm, pm = jax_make_mesh(n_data=8), cpu_mesh(8)
    for buckets in (None, [8, 16]):
        for jmesh, pmesh in ((None, None), (jm, pm)):
            assert resolve_buckets(buckets, pmesh) == jax_resolve_buckets(buckets, jmesh)
    assert resolve_buckets(None, pm) == [8, 64, 512]
    with pytest.raises(SystemExit, match="do not divide"):
        resolve_buckets([1, 8], pm)
