"""The JAX package's orbax checkpoints (``backend="orbax"`` and
``"orbax-async"``) in the port (``ugpg_tpu_torch/native/zstd.cpp``,
``io/ocdbt.py``, ``io/orbax.py``, ``io/checkpoint.py``), on the CPU at
width 0.25 unless stated.

* Codecs: zstd decodes every frame ``zstandard`` writes (levels 1, 3 and
  19, with and without a content checksum; hypothesis-drawn payloads, empty
  ones and ones over 128 KiB among them), and ``zstandard`` decodes the
  port's; CRC-32C's check value.
* OCDBT against tensorstore, both ways: the keys and values of a directory
  the JAX package wrote, of a tree of interior nodes and of a database of
  many versions (read at old generations too) equal tensorstore's, and
  tensorstore reads the same items from the port's database.
* Trees: a JAX orbax directory (a segmentation stage under RMSprop, the
  Herlev classifier under Adam with the frozen encoder's masked ``unet:
  {}``, and optax's empty states) reads in the port bit for bit as its msgpack twin does; the port's
  orbax directory of the same state loads in JAX's ``load_checkpoint`` with
  templates bit for bit; a zarr3 directory raises naming the field.
* Trainers: the port resumes a JAX orbax-async ``_last`` (square averages
  equal bit for bit, the next epoch within the train step's 1e-5), and the
  JAX trainer resumes the port's.
* orbax-async: parameters and moments changed in place right after the
  call are not in the checkpoint; a save over one in flight lands whole; a
  writer's error is raised at the next wait; a ``_last`` that never
  committed is passed over on resume.
* Readers: ``Predictor``, ``serve``'s registry, the MoNuSeg evaluator
  through ``test_monuseg`` and ``test_herlev`` answer from an orbax
  directory as from its ``.pth`` within 1e-4.
"""

import json
import os
import shutil

import numpy as np
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch
import zstandard
from flax import serialization
from hypothesis import HealthCheck, example, given, settings
from hypothesis import strategies as st

import jax
from tests.test_data_monuseg import write_monuseg_tree
from tests.test_torch_classifier import jax_cls_variables
from tests.test_torch_eval_monuseg import _metrics_match
from tests.test_torch_herlev_data import write_herlev_tree
from tests.test_torch_models import jax_variables
from tests.test_torch_msgpack_checkpoint import (  # noqa: F401 (a module fixture)
    STEP_TOL,
    W,
    _jax_cls_state,
    _jax_loaders,
    _jax_nu,
    _jax_seg_state,
    _port_loaders,
    _port_trainer,
    assert_same_leaves,
    one_torch_thread,
)
from ugpg_tpu.io.checkpoint import load_checkpoint as jax_load_checkpoint
from ugpg_tpu.io.checkpoint import save_checkpoint as jax_save_checkpoint
from ugpg_tpu.train.seg_trainer import UncertaintyGuidedProgressiveTrainer as JaxTrainer
from ugpg_tpu_torch import native
from ugpg_tpu_torch.cli import serve, test_herlev, test_monuseg
from ugpg_tpu_torch.eval.serving import Predictor
from ugpg_tpu_torch.io import ocdbt
from ugpg_tpu_torch.io import orbax as port_orbax
from ugpg_tpu_torch.io.checkpoint import (
    find_checkpoint,
    full_classifier_state_dict,
    has_checkpoint,
    read_checkpoint,
    save_checkpoint,
    wait_for_async_saves,
)
from ugpg_tpu_torch.io.from_jax import state_dict_from_jax
from ugpg_tpu_torch.models.pgunet import STAGE_MODELS
from ugpg_tpu_torch.train.optim import param_names, torch_rmsprop

ONE = {1: {"resolution": 16, "epochs_per_stage": 2, "lr": 3e-4}}
ONE_PART = {1: {**ONE[1], "epochs_per_stage": 1}}  # stopped after its first epoch
READ_TOL = 1e-4


# ---------------------------------------------------------------- codecs
def _big_payload(args) -> bytes:
    seed, size, alphabet = args
    return np.random.default_rng(seed).integers(0, alphabet, size, np.uint8).tobytes()


PAYLOADS = st.one_of(
    st.binary(max_size=2048),
    st.tuples(st.integers(0, 2**32 - 1), st.integers((128 << 10) + 1, 300_000),
              st.integers(1, 256)).map(_big_payload))


@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("level", [1, 3, 19])
@settings(max_examples=8, deadline=None, suppress_health_check=list(HealthCheck))
@given(data=PAYLOADS)
@example(data=b"")
@example(data=bytes(range(256)) * 600)  # 150 KiB, over zstd's 128 KiB block
def test_zstd_decodes_zstandard_frames_and_back(level, checksum, data):
    frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                     write_content_size=checksum).compress(data)
    assert bytes(native.zstd_decompress(frame)) == data
    assert bytes(native.zstd_decompress(frame, len(data))) == data
    ours = bytes(native.zstd_compress(data, level))
    assert zstandard.ZstdDecompressor().decompress(ours) == data


def test_zstd_refuses_corrupt_frames_and_crc32c_check_value():
    frame = bytearray(zstandard.ZstdCompressor(write_checksum=True).compress(b"x" * 5000))
    frame[-1] ^= 1
    with pytest.raises(ValueError, match="corrupt"):
        native.zstd_decompress(bytes(frame))
    with pytest.raises(ValueError, match="not a zstd frame"):
        native.zstd_decompress(b"not zstd")
    assert native.crc32c(b"123456789") == 0xE3069283
    assert native.crc32c(b"6789", native.crc32c(b"12345")) == 0xE3069283


# ---------------------------------------------------------------- OCDBT
def _ts_kvstore(path, **config):
    url = f"file://{os.path.abspath(path)}/|ocdbt:"
    spec = ts.KvStore.Spec(url).to_json() | {"config": config} if config else url
    return ts.KvStore.open(spec).result()


def _ts_items(path) -> dict[str, bytes]:
    kv = _ts_kvstore(path)
    return {k.decode(): kv.read(k).result().value for k in kv.list().result()}


def _make_database(case: str, root):
    """A database tensorstore wrote: a JAX orbax directory, a B-tree of
    interior nodes, or one key a version over 40 versions."""
    if case == "jax_orbax":
        rng = np.random.default_rng(0)
        tree = {"params": {"a": {"kernel": rng.standard_normal((3, 3, 8, 40), np.float32),
                                 "bias": np.zeros(40, np.float32)},
                           "b": {"scale": rng.standard_normal(700, np.float32)}},
                "batch_stats": {"a": {"mean": np.arange(4, dtype=np.float32)}}}
        jax_save_checkpoint(root, tree, ({"count": np.array(3, np.int32)}, {}),
                            {"stage": 1}, backend="orbax")
        return root / "variables_orbax"
    if case == "interior_nodes":
        kv = _ts_kvstore(root, max_decoded_node_bytes=200, compression=None)
        txn = ts.Transaction()
        for i in range(40):
            kv.with_transaction(txn).write(f"key{i:03d}/.zarray", bytes([i]) * (10 + 50 * i))
        txn.commit_async().result()
        return root
    kv = _ts_kvstore(root)
    for i in range(40):
        kv.write(f"v{i:02d}", bytes([i]) * i).result()
    return root


@pytest.mark.parametrize("case", ["jax_orbax", "interior_nodes", "versions"])
def test_ocdbt_against_tensorstore_both_ways(case, tmp_path):
    root = _make_database(case, tmp_path / "ts")
    want = _ts_items(root)
    db = ocdbt.Database(root)
    assert db.keys() == sorted(want)
    for key, value in want.items():
        assert db.read(key) == value, key
    if case == "jax_orbax":  # the process's own database, its data files beside it
        process = root / ocdbt.PROCESS_DIR
        assert {k: ocdbt.Database(process).read(k) for k in want} == _ts_items(process)
    if case == "versions":
        for generation in (2, 9, 17, 30, 41):  # in version-tree nodes and inline
            assert ocdbt.Database(root, generation=generation).keys() == [
                f"v{i:02d}" for i in range(generation - 1)]
    ocdbt.write_database(tmp_path / "port", want.items())
    assert _ts_items(tmp_path / "port") == want
    assert _ts_items(tmp_path / "port" / ocdbt.PROCESS_DIR) == want
    # the frame is checked: a flipped byte in a node fails its CRC-32C
    node = next((tmp_path / "port" / "d").iterdir())
    data = bytearray(node.read_bytes())
    data[20] ^= 0xFF
    node.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC-32C"):
        ocdbt.Database(tmp_path / "port")


# ---------------------------------------------------------------- trees
@pytest.mark.parametrize("which", ["seg1_rmsprop", "herlev2_frozen_adam"])
def test_jax_orbax_reads_as_its_msgpack_twin_and_back(which, tmp_path):
    variables, state = _jax_cls_state() if which.startswith("herlev") else _jax_seg_state(1)
    meta = {"stage": 2, "epoch": 1}
    twin = jax_save_checkpoint(tmp_path / "msgpack", variables, state, meta)
    orbax = jax_save_checkpoint(tmp_path / "orbax", variables, state, meta, backend="orbax")
    got, want = read_checkpoint(orbax), read_checkpoint(twin)
    assert got.keys() == want.keys()
    for k, v in want["model_state_dict"].items():
        assert torch.equal(got["model_state_dict"][k], v), k
    assert_same_leaves(got["optimizer_state_dict"], want["optimizer_state_dict"])
    # the port writes the state back; JAX restores it with its templates
    back = save_checkpoint(tmp_path / "port", got["model_state_dict"], backend="orbax",
                           optimizer_state_dict=got["optimizer_state_dict"], stage=2)
    assert sorted(p.name for p in back.iterdir()) == [
        "metadata.json", "opt_state_orbax", "variables_orbax"]
    v2, s2, m2 = jax_load_checkpoint(back, variables_template=variables,
                                     opt_state_template=state)
    assert m2 == {"stage": 2}
    for a, b in ((v2, variables), (s2, state)):
        assert jax.tree.structure(a) == jax.tree.structure(b)
        assert_same_leaves(jax.device_get(serialization.to_state_dict(a)),
                           jax.device_get(serialization.to_state_dict(b)))


def test_variants_the_jax_package_never_writes_raise(tmp_path):
    tree = {"params": {"a": np.ones(3, np.float32)}}
    port_orbax.write_pytree(tmp_path / "v", tree)
    meta = json.loads((tmp_path / "v" / "_METADATA").read_text())
    (tmp_path / "v" / "_METADATA").write_text(json.dumps({**meta, "use_zarr3": True}))
    with pytest.raises(ValueError, match="use_zarr3"):
        port_orbax.read_pytree(tmp_path / "v")
    assert not (tmp_path / f"v{port_orbax.TMP_SUFFIX}").exists()  # renamed into place


# ---------------------------------------------------------------- trainers
@pytest.fixture(scope="module")
def jax_orbax_run(tmp_path_factory):
    """The JAX trainer's orbax-async run stopped after stage 1's first
    epoch, a copy of it, and the JAX trainer's resumed history."""
    d = tmp_path_factory.mktemp("jax_orbax_run")
    train, val = _jax_loaders()
    JaxTrainer(stage_configs=ONE_PART, width=W, verbose=False,
               checkpoint_backend="orbax-async").train_progressive(
        train, val, max_stages=1, save_dir=d / "run", checkpoint_every=1)
    shutil.copytree(d / "run", d / "before")
    resumed = JaxTrainer(stage_configs=ONE, width=W, verbose=False,
                         checkpoint_backend="orbax-async").train_progressive(
        train, val, max_stages=1, save_dir=d / "run", checkpoint_every=1, resume=True)
    return {"before": d / "before", "history": resumed}


def test_port_resumes_a_jax_orbax_async_last(jax_orbax_run, tmp_path):
    run = tmp_path / "run"
    shutil.copytree(jax_orbax_run["before"], run)
    last = run / "ug_pgunet_stage1_last"
    assert (last / "variables_orbax").is_dir() and find_checkpoint(run, last.name) == last
    jax_opt = ocp.PyTreeCheckpointer().restore((last / "opt_state_orbax").resolve())
    t = _port_trainer(ONE)
    assert t._find_resume_point(run) == (1, 0)
    t.setup_optimizer(1)
    t._restore_last(run, 1)
    for p, name in zip(t.optimizer.param_groups[0]["params"],
                       param_names(t.optimizer, t.models[1])):
        np.testing.assert_array_equal(t.optimizer.state[p]["square_avg"].numpy(),
                                      _jax_nu(jax_opt, name), name)
        assert float(t.optimizer.state[p]["step"]) == float(jax_opt["count"])
    train, val = _port_loaders()
    hist = _port_trainer(ONE, checkpoint_backend="orbax").train_progressive(
        train, val, max_stages=1, save_dir=run, checkpoint_every=1, resume=True)
    want = jax_orbax_run["history"]
    for key, values in want.items():
        if key == "stage_transitions":
            continue
        assert len(hist[key]) == len(values) == 2, key
        np.testing.assert_allclose(hist[key][1], values[1], atol=STEP_TOL, rtol=STEP_TOL,
                                   err_msg=key)
    assert json.loads((last / "metadata.json").read_text())["epoch"] == 1


def test_jax_resumes_the_ports_orbax_async_last_and_a_torn_one_is_passed_over(tmp_path):
    train, val = _port_loaders()
    tr = _port_trainer(ONE_PART, checkpoint_backend="orbax-async")
    tr.train_progressive(train, val, max_stages=1, save_dir=tmp_path, checkpoint_every=1)
    last = tmp_path / "ug_pgunet_stage1_last"
    assert sorted(p.name for p in last.iterdir()) == [
        "metadata.json", "opt_state_orbax", "variables_orbax"]
    jt = JaxTrainer(stage_configs=ONE, width=W, verbose=False)
    jt.setup_optimizer(1)
    _, opt_state, meta = jax_load_checkpoint(last, variables_template=jt._ensure_variables(1),
                                             opt_state_template=jt._state.opt_state)
    assert meta["stage"] == 1 and meta["epoch"] == 0
    tree = jax.device_get(serialization.to_state_dict(opt_state))
    for p, name in zip(tr.optimizer.param_groups[0]["params"],
                       param_names(tr.optimizer, tr.models[1])):
        np.testing.assert_array_equal(_jax_nu(tree, name),
                                      tr.optimizer.state[p]["square_avg"].numpy(), name)
    # an orbax-async save of stage 2 that never committed: metadata, no tree
    torn = tmp_path / "ug_pgunet_stage2_last"
    (torn / f"variables_orbax{port_orbax.TMP_SUFFIX}").mkdir(parents=True)
    (torn / "metadata.json").write_text(json.dumps({"stage": 2, "epoch": 0}))
    assert not has_checkpoint(torn) and _port_trainer(ONE)._find_resume_point(tmp_path) == (1, 0)
    jax_train, jax_val = _jax_loaders()
    hist = JaxTrainer(stage_configs=ONE, width=W, verbose=False).train_progressive(
        jax_train, jax_val, max_stages=1, save_dir=tmp_path, checkpoint_every=1, resume=True)
    assert len(hist["train_loss"]) == 2 and np.isfinite(hist["train_loss"]).all()


# ---------------------------------------------------------------- orbax-async
def _model_and_optimizer():
    torch.manual_seed(0)
    model = STAGE_MODELS[1](num_classes=1, use_bn=True, width=W)
    opt = torch_rmsprop(model.parameters(), 3e-4, weight_decay=1e-4)
    for p in model.parameters():
        p.grad = torch.randn_like(p)
    opt.step()
    return model, opt


def _save(path, model, opt, **meta):
    return save_checkpoint(path, model.state_dict(), backend="orbax-async",
                           param_names=param_names(opt, model),
                           optimizer_state_dict=opt.state_dict(), stage=1, **meta)


def test_async_save_is_a_snapshot_and_overwrites_in_flight_land_whole(tmp_path):
    model, opt = _model_and_optimizer()
    want = {k: v.clone() for k, v in model.state_dict().items()}
    square = [opt.state[p]["square_avg"].clone() for p in model.parameters()]
    path = _save(tmp_path / "ck", model, opt, epoch=0)
    with torch.no_grad():  # the next step's in-place writes, at once
        for p in model.parameters():
            p.add_(1.0)
            opt.state[p]["square_avg"].mul_(3.0)
    got = read_checkpoint(path)  # waits
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got["model_state_dict"][k], v), k
    fresh, fresh_opt = _model_and_optimizer()
    from ugpg_tpu_torch.train.optim import load_optimizer_state

    load_optimizer_state(fresh_opt, got["optimizer_state_dict"], param_names(fresh_opt, fresh))
    for p, s in zip(fresh.parameters(), square):
        assert torch.equal(fresh_opt.state[p]["square_avg"], s)
    # two saves over one directory, the second while the first may still write
    _save(path, model, opt, epoch=1)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(2.0)
    _save(path, model, opt, epoch=2)
    wait_for_async_saves()
    got = read_checkpoint(path)
    assert got["epoch"] == 2
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got["model_state_dict"][k], v), k
    assert not list(path.glob(f"*{port_orbax.TMP_SUFFIX}")) and not list(path.glob("*.replaced"))


def test_a_writers_error_is_raised_at_the_next_wait(tmp_path, monkeypatch):
    model, opt = _model_and_optimizer()

    def broken(directory, tree):
        raise OSError("disk full")

    monkeypatch.setattr(port_orbax, "write_pytree", broken)
    path = _save(tmp_path / "ck", model, opt, epoch=0)
    with pytest.raises(OSError, match="disk full"):
        wait_for_async_saves()
    wait_for_async_saves()  # raised once, then the writers are idle
    assert not has_checkpoint(path) and find_checkpoint(tmp_path, "ck") is None


# ---------------------------------------------------------------- readers
@pytest.fixture(scope="module")
def orbax_and_pth(tmp_path_factory):
    """A JAX-written stage-1 orbax ``_best`` (full width: the evaluators
    read the reference widths), the same weights as a ``.pth``, a MoNuSeg
    tree, and such a pair the port wrote for a stage-1 Herlev classifier,
    with a tree."""
    d = tmp_path_factory.mktemp("orbax_readers")
    meta = {"stage": 1, "epoch": 4, "val_dice": 0.5, "train_dice": 0.4,
            "uncertainty_alpha": 1.0}
    v = jax_variables(1, width=1.0, seed=21)
    orbax = jax_save_checkpoint(d / "ug_pgunet_stage1_best", v, metadata=meta,
                                backend="orbax")
    pth = save_checkpoint(d / "ug_pgunet_stage1_best.pth", state_dict_from_jax(v), **meta)
    cls_sd = full_classifier_state_dict(state_dict_from_jax(jax_cls_variables(1, 7, seed=22)), 1)
    cls_meta = {"stage": 1, "epoch": 1, "config": {"num_classes": 7}}
    cls = save_checkpoint(d / "herlev_stage1_best", cls_sd, backend="orbax", **cls_meta)
    cls_pth = save_checkpoint(d / "herlev_stage1_best.pth", cls_sd, **cls_meta)
    return {"seg": (orbax, pth), "cls": (cls, cls_pth),
            "monuseg": write_monuseg_tree(d / "M", n_train=1, n_val=2, size=64),
            "herlev": write_herlev_tree(d / "Herlev")}


def test_readers_answer_from_an_orbax_directory_as_from_its_pth(orbax_and_pth, tmp_path):
    orbax, pth = orbax_and_pth["seg"]
    x = np.random.default_rng(2).random((2, 32, 32, 3), dtype=np.float32)
    args = serve.build_argparser().parse_args(["--model", f"o={orbax}", "--model", f"p={pth}",
                                               "--device", "cpu", "--buckets", "2"])
    registry = serve.build_registry(args)  # a Predictor each
    try:
        assert isinstance(registry.get("o"), Predictor)
        for a, b in zip(registry.predict("o", x), registry.predict("p", x)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=READ_TOL)
    finally:
        registry.close()
    tree = str(orbax_and_pth["monuseg"])
    res = [test_monuseg.main(["--model", str(m), "--data", tree, "--eval_full", "--device",
                              "cpu", "--output_dir", str(tmp_path / m.name)])
           for m in (orbax, pth)]
    _metrics_match(res[0]["metrics"], res[1]["metrics"])
    cls, cls_pth = orbax_and_pth["cls"]
    herlev = [test_herlev.main(["--model", str(m), "--data_dir", str(orbax_and_pth["herlev"]),
                                "--device", "cpu", "--split", "val",
                                "--output_dir", str(tmp_path / f"h{i}")])
              for i, m in enumerate((cls, cls_pth))]
    assert herlev[0]["num_samples"] == herlev[1]["num_samples"] > 0
    np.testing.assert_allclose(herlev[0]["accuracy"], herlev[1]["accuracy"], atol=READ_TOL)
    np.testing.assert_allclose(herlev[0]["roc_auc"], herlev[1]["roc_auc"], atol=READ_TOL)
