"""The JAX package's default checkpoint format, flax-msgpack directories, in
the port (``ugpg_tpu_torch/io/msgpack.py``, ``io/checkpoint.py``,
``io/from_jax.py``, ``train/optim.py``), on the CPU at width 0.25 unless
stated.

* The codec against flax: the bytes of the JAX package's own variable and
  optax trees (segmentation stages 1 and 4 under RMSprop, the Herlev stage-2
  classifier under Adam with the frozen encoder, one full-width stage-4
  variable tree) equal ``flax.serialization.to_bytes``'s, and
  ``msgpack_restore`` gives flax's leaves with their dtypes; the same trees
  through the port's state dict and torch optimizer and back give the same
  bytes again.  Edge cases of the msgpack format against the ``msgpack``
  package as flax calls it, and chunked arrays with both limits lowered.
* JAX reads the port: the JAX package's ``load_checkpoint`` with its own
  templates loads a ``_last`` directory the port trainer wrote, and its
  trainer resumes from it (the epochs and history of
  ``tests/test_torch_resume.py``'s ``jax_resume``).
* The port reads JAX: the port trainer resumes from the JAX trainer's
  ``_last`` directory; its next epoch's metrics match the JAX trainer's
  resumed epoch within 1e-5 (the train-step tolerance), the square
  averages are JAX's ``nu`` transposed bit for bit, and the port writes the
  restored state back as the same bytes.  A Herlev ``_last`` with the
  frozen encoder resumes with Adam's moments, step and halved learning rate
  equal.
* Readers: ``Predictor``, the MoNuSeg evaluator and ``test_monuseg --model
  <dir>`` on a JAX-written ``_best`` directory answer as the JAX package's
  own within 1e-4.
* Forms: an orbax save that never committed is no checkpoint, one that did
  reads back, a directory without either tree is none, and of a ``.pth``
  and a directory of one name the later epoch's is taken.
"""

import json
import shutil
import time

import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

import jax
import jax.numpy as jnp
from tests.test_data_monuseg import write_monuseg_tree
from tests.test_torch_classifier import jax_cls_variables
from tests.test_torch_eval_monuseg import _maps_match, _metrics_match
from tests.test_torch_models import jax_variables
from ugpg_tpu.data.synthetic import ArrayLoader as JaxArrayLoader
from ugpg_tpu.data.synthetic import disk_dataset as jax_disk_dataset
from ugpg_tpu.eval.monuseg import MoNuSegEvaluator as JaxEvaluator
from ugpg_tpu.eval.serving import Predictor as JaxPredictor
from ugpg_tpu.io.checkpoint import load_checkpoint as jax_load_checkpoint
from ugpg_tpu.io.checkpoint import save_checkpoint as jax_save_checkpoint
from ugpg_tpu.train import cls_trainer as jax_cls_trainer
from ugpg_tpu.train.cls_trainer import HerlevTrainer as JaxHerlevTrainer
from ugpg_tpu.train.optim import freeze_subtrees as jax_freeze
from ugpg_tpu.train.optim import set_learning_rate as jax_set_lr
from ugpg_tpu.train.optim import torch_adam as jax_adam
from ugpg_tpu.train.optim import torch_rmsprop as jax_rmsprop
from ugpg_tpu.train.seg_trainer import UncertaintyGuidedProgressiveTrainer as JaxTrainer
from ugpg_tpu.utils.preemption import PreemptionGuard as JaxPreemptionGuard
from ugpg_tpu_torch.cli import test_monuseg
from ugpg_tpu_torch.data.monuseg import MoNuSegDataset
from ugpg_tpu_torch.data.synthetic import ArrayLoader, disk_dataset
from ugpg_tpu_torch.eval.monuseg import MoNuSegEvaluator
from ugpg_tpu_torch.eval.serving import Predictor
from ugpg_tpu_torch.io import msgpack as port_msgpack
from ugpg_tpu_torch.io.checkpoint import (
    find_checkpoint,
    has_checkpoint,
    latest_checkpoint,
    load_checkpoint,
    read_checkpoint,
    save_checkpoint,
    sniff_stage,
)
from ugpg_tpu_torch.io.from_jax import jax_variables_from_state_dict, state_dict_from_jax
from ugpg_tpu_torch.models.classifier import HerlevClassificationModel
from ugpg_tpu_torch.models.pgunet import STAGE_MODELS
from ugpg_tpu_torch.train.cls_trainer import HerlevTrainer
from ugpg_tpu_torch.train.optim import (
    freeze_subtrees,
    load_optimizer_state,
    optimizer_state_to_jax,
    param_names,
    torch_adam,
    torch_rmsprop,
)
from ugpg_tpu_torch.train.seg_trainer import UncertaintyGuidedProgressiveTrainer

W = 0.25
CFGS = {
    1: {"resolution": 16, "epochs_per_stage": 3, "lr": 3e-4},
    2: {"resolution": 32, "epochs_per_stage": 3, "lr": 1e-4},
}
# stage 1 whole, stage 2 stopped after its first epoch
PART = {1: dict(CFGS[1]), 2: {**CFGS[2], "epochs_per_stage": 1}}
STEP_TOL = 1e-5  # the train step's tolerance against JAX (tests/test_torch_train.py)
K = 3  # Herlev classes


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: the suite runs six test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flax_bytes(tree) -> bytes:
    """What the JAX package's ``save_checkpoint`` writes for ``tree``."""
    return serialization.to_bytes(jax.device_get(tree))


def assert_same_leaves(got, want, path=""):
    """Equal trees: the same keys, and leaves equal bit for bit with their
    dtype and type (an ndarray or a numpy scalar)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            assert_same_leaves(got[k], want[k], f"{path}/{k}")
        return
    assert type(got) is type(want), path
    if isinstance(want, (np.ndarray, np.generic)):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, path


def _random_like(tree, seed):
    g = np.random.default_rng(seed)
    return jax.tree.map(lambda x: np.asarray(g.standard_normal(np.shape(x)), np.float32), tree)


def _jax_seg_state(stage):
    """A JAX stage's variables and its RMSprop state after one update."""
    variables = jax_variables(stage, width=W, seed=stage)
    tx = jax_rmsprop(3e-4, weight_decay=1e-4)
    state = tx.init(variables["params"])
    _, state = tx.update(_random_like(variables["params"], 7), state, variables["params"])
    return variables, state


def _jax_cls_state():
    """The stage-2 Herlev classifier's variables and the frozen-encoder Adam
    state after two updates, its learning rate halved."""
    variables = jax_cls_variables(2, num_classes=K, seed=5)
    tx = jax_freeze(jax_adam(1e-4, weight_decay=1e-4), ("unet",))
    state = tx.init(variables["params"])
    for seed in (8, 9):
        _, state = tx.update(_random_like(variables["params"], seed), state, variables["params"])
    return variables, jax_set_lr(state, 5e-5)


# ---------------------------------------------------------------- the codec
@pytest.mark.parametrize("which", ["seg1", "seg4", "herlev2_frozen"])
def test_bytes_equal_flax_on_the_jax_packages_trees(which):
    if which == "herlev2_frozen":
        variables, state = _jax_cls_state()
        model = HerlevClassificationModel(2, K, use_bn=True)
        model.load_state_dict(state_dict_from_jax(variables), strict=True)
        optimizer = torch_adam(freeze_subtrees(model, ("unet",)), 1e-4, weight_decay=1e-4)
    else:
        stage = int(which[-1])
        variables, state = _jax_seg_state(stage)
        model = STAGE_MODELS[stage](num_classes=1, use_bn=True, width=W)
        model.load_state_dict(state_dict_from_jax(variables), strict=True)
        optimizer = torch_rmsprop(model.parameters(), 3e-4, weight_decay=1e-4)
    opt_tree = jax.device_get(serialization.to_state_dict(state))
    for tree in (variables, opt_tree):
        want = flax_bytes(tree)
        assert port_msgpack.to_bytes(tree) == want
        assert_same_leaves(port_msgpack.msgpack_restore(want),
                           serialization.msgpack_restore(want))
    # the same trees through the port's state dict and torch optimizer
    assert port_msgpack.to_bytes(jax_variables_from_state_dict(model.state_dict())) == \
        flax_bytes(variables)
    names = param_names(optimizer, model)
    load_optimizer_state(optimizer, port_msgpack.msgpack_restore(flax_bytes(opt_tree)), names)
    back = optimizer_state_to_jax(optimizer.state_dict(), names, variables["params"])
    assert port_msgpack.to_bytes(back) == flax_bytes(opt_tree)
    # and the JAX package restores the port's tree into its own template
    restored = serialization.from_state_dict(state, port_msgpack.msgpack_restore(
        port_msgpack.to_bytes(back)))
    assert jax.tree.structure(restored) == jax.tree.structure(state)


def test_full_width_stage4_tree_bytes_equal_flax_and_take_no_python_loop_time(tmp_path):
    variables = jax_variables(4, width=1.0, seed=4)
    t0 = time.perf_counter()
    want = flax_bytes(variables)
    t_flax = time.perf_counter() - t0
    t0 = time.perf_counter()
    sd = state_dict_from_jax(port_msgpack.msgpack_restore(want))
    got = port_msgpack.to_bytes(jax_variables_from_state_dict(sd))
    t_port = time.perf_counter() - t0
    assert got == want and len(want) > 50 << 20
    # a directory the port writes from that state dict, read back
    save_checkpoint(tmp_path / "ug_pgunet_stage4_best", sd, backend="msgpack", stage=4)
    assert (tmp_path / "ug_pgunet_stage4_best" / "variables.msgpack").read_bytes() == want
    stage, back = load_checkpoint(tmp_path / "ug_pgunet_stage4_best")
    assert stage == 4 and all(torch.equal(back[k], v) for k, v in sd.items())
    assert t_port < 20.0, (t_port, t_flax)


EDGE_CASES = {
    "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 63,
             2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1,
             -2 ** 63],
    "floats": {"py": 1.0 / 3.0, "f32": np.float32(1.0 / 3.0), "f64": np.float64(-2.5e-300),
               "inf": float("inf")},
    "long_str": {"s" * 31: "x" * 31, "t" * 32: "y" * 256, "u": "z" * 70000},
    "long_bin": {"b8": b"\x01" * 255, "b16": b"\x02" * 65535, "b32": b"\x03" * 65536},
    "empty_maps": {"a": {}, "b": {"c": {}, "d": {"e": {}}}},
    "np_scalars": {"i8": np.int8(-5), "u64": np.uint64(2 ** 63 + 5), "b": np.bool_(True),
                   "f16": np.float16(0.5), "c64": np.complex64(1 - 2j)},
    "arrays": {"e": np.zeros((0, 3), np.float32), "s": np.array(7, np.int32),
               "d": np.arange(24, dtype=np.float64).reshape(2, 3, 4),
               "u": np.arange(70000, dtype=np.uint8), "big": np.ones((300, 300), np.float32)},
    "maps_and_arrays": {str(i): [i] * i for i in range(20)},
    "misc": {"none": None, "t": True, "f": False, "c": 1 + 2j, "k": {"z": 1, "a": 2}},
}


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_codec_edge_cases_equal_flax(case):
    tree = EDGE_CASES[case]
    want = serialization.msgpack_serialize(tree)
    got = port_msgpack.to_bytes(tree)
    assert got == want
    back, ref = port_msgpack.msgpack_restore(got), serialization.msgpack_restore(want)
    if isinstance(ref, dict):
        assert_same_leaves(back, ref)
    else:
        assert back == ref


def test_plain_msgpack_reads_float32_and_rejects_what_flax_never_writes():
    for value in (1.5, -3, 2 ** 40, "abc", [1.25, None]):
        assert port_msgpack.unpackb(msgpack.packb(value, use_single_float=True)) == value
    assert port_msgpack.packb({"b": 1, "a": 2}) == msgpack.packb({"b": 1, "a": 2})  # order kept
    with pytest.raises(ValueError, match="after the object"):
        port_msgpack.unpackb(msgpack.packb(1) + b"\x00")
    with pytest.raises(ValueError, match="ends early"):
        port_msgpack.unpackb(msgpack.packb("abcdef")[:-1])
    with pytest.raises(ValueError, match="none of flax's"):
        port_msgpack.unpackb(msgpack.packb(msgpack.ExtType(5, b"x")))


def test_chunked_arrays_both_ways(monkeypatch):
    """Arrays over the chunk limit become flax's ``__msgpack_chunked_array__``
    maps and join again, both limits lowered to 64 bytes."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(port_msgpack, "MAX_CHUNK_SIZE", 64)
    tree = {"w": np.arange(100, dtype=np.float32).reshape(10, 10),
            "v": {"x": np.arange(7, dtype=np.int16), "y": np.arange(33, dtype=np.float64)}}
    want = serialization.msgpack_serialize(tree)
    assert port_msgpack.to_bytes(tree) == want
    raw = port_msgpack.unpackb(want)
    assert raw["w"]["__msgpack_chunked_array__"] and len(raw["w"]["chunks"]) == 7
    assert_same_leaves(port_msgpack.msgpack_restore(want), serialization.msgpack_restore(want))


# ---------------------------------------------------------------- JAX <-> port trainers
def _port_loaders():
    images, masks = disk_dataset(num_samples=12, image_size=32, seed=3)
    return (ArrayLoader(images[:8], masks[:8], batch_size=4),
            ArrayLoader(images[8:], masks[8:], batch_size=4))


def _jax_loaders():
    images, masks = jax_disk_dataset(num_samples=12, image_size=32, seed=3)
    return (JaxArrayLoader(images[:8], masks[:8], batch_size=4),
            JaxArrayLoader(images[8:], masks[8:], batch_size=4))


def _port_trainer(cfgs=CFGS, **kw):
    return UncertaintyGuidedProgressiveTrainer(stage_configs=cfgs, width=W, verbose=False,
                                               device="cpu", **kw)


def _jax_nu(tree, name):
    """The JAX ``nu`` of the port parameter ``name``, in the port's layout."""
    from ugpg_tpu_torch.io.from_jax import from_jax_layout, jax_leaf

    node = tree["inner_state"]["1"]["nu"]
    for key in jax_leaf(name)[1:]:
        node = node[key]
    return from_jax_layout(np.asarray(node))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX trainer's run stopped mid-stage-2 (msgpack, its default), a
    copy of that output directory, and the JAX trainer's resumed history."""
    d = tmp_path_factory.mktemp("jax_run")
    train, val = _jax_loaders()
    JaxTrainer(stage_configs=PART, width=W, verbose=False).train_progressive(
        train, val, max_stages=2, save_dir=d / "run", checkpoint_every=1)
    shutil.copytree(d / "run", d / "before")
    resumed = JaxTrainer(stage_configs=CFGS, width=W, verbose=False).train_progressive(
        train, val, max_stages=2, save_dir=d / "run", checkpoint_every=1, resume=True)
    return {"before": d / "before", "history": resumed}


def test_jax_loads_and_resumes_a_port_directory(tmp_path):
    train, val = _port_loaders()
    tr = _port_trainer(PART, checkpoint_backend="msgpack")
    tr.train_progressive(train, val, max_stages=2, save_dir=tmp_path, checkpoint_every=1)
    last = tmp_path / "ug_pgunet_stage2_last"
    assert sorted(p.name for p in last.iterdir()) == [
        "metadata.json", "opt_state.msgpack", "variables.msgpack"]
    assert not list(tmp_path.glob("*.pth"))
    jt = JaxTrainer(stage_configs=CFGS, width=W, verbose=False)
    jt.setup_optimizer(2)
    variables, opt_state, meta = jax_load_checkpoint(
        last, variables_template=jt._ensure_variables(2), opt_state_template=jt._state.opt_state)
    assert meta["stage"] == 2 and meta["epoch"] == 0
    assert len(meta["history"]["train_loss"]) == 4
    assert meta["history"]["stage_transitions"] == [0, 3]
    assert jax.tree.structure(opt_state) == jax.tree.structure(jt._state.opt_state)
    sd = tr.models[2].state_dict()
    np.testing.assert_array_equal(np.asarray(variables["params"]["inc"]["conv"]["conv1"]["kernel"]),
                                  sd["inc.conv.conv_op.0.weight"].numpy().transpose(2, 3, 1, 0))
    tree = jax.device_get(serialization.to_state_dict(opt_state))
    for p, name in zip(tr.optimizer.param_groups[0]["params"], param_names(tr.optimizer,
                                                                          tr.models[2])):
        np.testing.assert_array_equal(_jax_nu(tree, name),
                                      tr.optimizer.state[p]["square_avg"].numpy(), name)
    assert int(tree["count"]) == int(tr.optimizer.state[p]["step"])
    # the JAX trainer resumes: the epochs and history of the jax_resume case
    jax_train, jax_val = _jax_loaders()
    hist = JaxTrainer(stage_configs=CFGS, width=W, verbose=False).train_progressive(
        jax_train, jax_val, max_stages=2, save_dir=tmp_path, checkpoint_every=1, resume=True)
    assert {k: len(v) for k, v in hist.items() if k != "stage_transitions"} == {
        k: 6 for k in hist if k != "stage_transitions"}
    assert hist["stage_transitions"] == [0, 3]
    assert json.loads((last / "metadata.json").read_text())["epoch"] == 2


def test_port_resumes_a_jax_directory(jax_run, tmp_path):
    run = tmp_path / "run"
    shutil.copytree(jax_run["before"], run)
    last = run / "ug_pgunet_stage2_last"
    jax_opt = port_msgpack.msgpack_restore((last / "opt_state.msgpack").read_bytes())
    # the restored optimizer state is JAX's, and writes back as its bytes
    t = _port_trainer()
    assert t._find_resume_point(run) == (2, 0)
    t.setup_optimizer(2)
    t._restore_last(run, 2)
    names = param_names(t.optimizer, t.models[2])
    for p, name in zip(t.optimizer.param_groups[0]["params"], names):
        np.testing.assert_array_equal(t.optimizer.state[p]["square_avg"].numpy(),
                                      _jax_nu(jax_opt, name), name)
        assert float(t.optimizer.state[p]["step"]) == float(jax_opt["count"])
    t.checkpoint_backend = "msgpack"
    again = t._checkpoint(tmp_path / "again", "ug_pgunet_stage2_last", 2, 0)
    for f in ("variables.msgpack", "opt_state.msgpack"):
        assert (again / f).read_bytes() == (last / f).read_bytes(), f
    # the next epochs match the JAX trainer's resumed ones
    train, val = _port_loaders()
    hist = _port_trainer().train_progressive(train, val, max_stages=2, save_dir=run,
                                             checkpoint_every=1, resume=True)
    want = jax_run["history"]
    assert hist["stage_transitions"] == want["stage_transitions"] == [0, 3]
    for key, values in want.items():
        if key == "stage_transitions":
            continue
        assert len(hist[key]) == len(values) == 6, key
        np.testing.assert_allclose(hist[key][4], values[4], atol=STEP_TOL, rtol=STEP_TOL,
                                   err_msg=key)
    assert (run / "ug_pgunet_stage2_last.pth").is_file()  # the port's own default backend
    assert find_checkpoint(run, "ug_pgunet_stage2_last") == run / "ug_pgunet_stage2_last.pth"


def test_port_directory_round_trip_resumes_on_the_same_bits(tmp_path):
    """A ``_last`` directory the port wrote restores weights, BN stats and
    RMSprop state exactly (the learning rate from the metadata's exact
    float): one more step equals the uninterrupted run's, bit for bit."""
    train, val = _port_loaders()
    cfgs = {1: {**CFGS[1], "epochs_per_stage": 2}}
    t1 = _port_trainer(cfgs, checkpoint_backend="msgpack")
    t1.train_progressive(train, val, max_stages=1, save_dir=tmp_path, checkpoint_every=2)
    t2 = _port_trainer(cfgs)
    assert t2._find_resume_point(tmp_path) == (1, 1)
    t2.setup_optimizer(1)
    t2._restore_last(tmp_path, 1)
    assert t2.history == t1.history
    assert t2.optimizer.param_groups[0]["lr"] == t1.optimizer.param_groups[0]["lr"] == 3e-4
    batch = next(iter(train))
    m1 = t1._get_train_step(1)(batch, t1.pos_weight)
    m2 = t2._get_train_step(1)(batch, t2.pos_weight)
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k
    s1, s2 = t1.models[1].state_dict(), t2.models[1].state_dict()
    for key in s1:
        if not key.endswith("num_batches_tracked"):  # flax has no counter: it reads back as 0
            assert torch.equal(s1[key], s2[key]), key
    o1, o2 = t1.optimizer.state_dict()["state"], t2.optimizer.state_dict()["state"]
    for i in o1:
        for k in o1[i]:
            assert torch.equal(torch.as_tensor(o1[i][k]), torch.as_tensor(o2[i][k])), (i, k)


def test_herlev_jax_frozen_last_resumes_in_the_port(tmp_path, monkeypatch):
    """The JAX Herlev trainer with a pretrained, frozen stage-2 encoder
    (a segmentation directory) is preempted after stage 2's first epoch; its
    plateau scheduler, patience -1, has halved the learning rate.  The port,
    frozen the same way from the same directory, restores Adam's moments,
    step and learning rate equal, writes them back as JAX's bytes, and
    finishes the stage."""
    seg = jax_save_checkpoint(tmp_path / "seg2", jax_variables(2, width=1.0, seed=12),
                              metadata={"stage": 2})
    rng = np.random.default_rng(0)
    labels = rng.integers(0, K, 6)
    loaders = {}
    for px, stage in ((32, 1), (64, 2)):
        imgs = rng.random((6, px, px, 3)).astype(np.float32) * 0.3
        for i, lab in enumerate(labels):
            imgs[i, :, :, lab] += 0.6
        loaders[stage] = (imgs, labels)
    cfg = jax_cls_trainer.create_config()
    cfg.update(num_classes=K, stages=[1, 2], epochs_per_stage=2, verbose=False,
               class_weights=[1.0, 2.0, 0.5], pretrained_unet_paths={2: str(seg)},
               augment=False)
    real = jax_cls_trainer.ReduceLROnPlateau
    monkeypatch.setattr(jax_cls_trainer, "ReduceLROnPlateau",
                        lambda **kw: real(**{**kw, "patience": -1}))

    class StopAtStage2(JaxPreemptionGuard):
        polls = 0

        def should_stop(self):
            self.polls += 1
            if self.polls == 3:  # stage 1: two epochs; stage 2: its first
                self.trigger()
            return super().should_stop()

    jt = JaxHerlevTrainer(cfg)
    jl = {s: JaxArrayLoader(x[:4], y[:4], batch_size=2) for s, (x, y) in loaders.items()}
    jv = {s: JaxArrayLoader(x[4:], y[4:], batch_size=2) for s, (x, y) in loaders.items()}
    jt.train_progressive(jl, jv, str(tmp_path / "out"), preemption=StopAtStage2())
    last = tmp_path / "out" / "herlev_stage2_last"
    assert jt.preempted and has_checkpoint(last) and sniff_stage(last) == 2
    jax_opt = port_msgpack.msgpack_restore((last / "opt_state.msgpack").read_bytes())
    adam = jax_opt["inner_states"]["train"]["inner_state"]
    assert adam["inner_state"]["1"]["mu"]["unet"] == {}  # the masked encoder

    pt = HerlevTrainer({**cfg, "class_weights": [1.0, 2.0, 0.5]}, device="cpu")
    stage, meta = pt._find_resume_point(tmp_path / "out")
    assert stage == 2 and meta["epoch"] == 1
    pt.setup_optimizer_scheduler(2)
    pt._restore_last(2, meta)
    model = pt.models[2]
    assert not any(p.requires_grad for n, p in model.named_parameters() if n.startswith("unet."))
    group = pt.optimizer.param_groups[0]
    assert np.float32(group["lr"]) == adam["hyperparams"]["lr"] == np.float32(5e-5)  # halved
    from ugpg_tpu_torch.io.from_jax import from_jax_layout, jax_leaf

    for p, name in zip(group["params"], param_names(pt.optimizer, model)):
        st = pt.optimizer.state[p]
        for torch_key, key in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
            node = adam["inner_state"]["1"][key]
            for part in jax_leaf(name)[1:]:
                node = node[part]
            np.testing.assert_array_equal(st[torch_key].numpy(), from_jax_layout(node), name)
        assert float(st["step"]) == int(adam["inner_state"]["1"]["count"]) == 2
    pt.checkpoint_backend = "msgpack"
    again = pt._save(tmp_path / "again", "herlev_stage2_last", 2, 1)
    for f in ("variables.msgpack", "opt_state.msgpack"):
        assert (again / f).read_bytes() == (last / f).read_bytes(), f
    # the port finishes the stage from JAX's directory
    pl = {s: ArrayLoader(x[:4], y[:4], batch_size=2) for s, (x, y) in loaders.items()}
    pv = {s: ArrayLoader(x[4:], y[4:], batch_size=2) for s, (x, y) in loaders.items()}
    done = HerlevTrainer({**cfg, "class_weights": [1.0, 2.0, 0.5]}, device="cpu")
    hist = done.train_progressive(pl, pv, str(tmp_path / "out"), resume=True)
    assert len(hist["train_loss"]) == 4 and not done.preempted


# ---------------------------------------------------------------- readers
@pytest.fixture(scope="module")
def jax_best(tmp_path_factory):
    """A JAX-written stage-1 ``_best`` directory (full width: the JAX
    evaluators have no width option) and a MoNuSeg tree."""
    d = tmp_path_factory.mktemp("jax_best")
    best = jax_save_checkpoint(d / "ug_pgunet_stage1_best", jax_variables(1, width=1.0, seed=21),
                               metadata={"stage": 1, "epoch": 4, "val_dice": 0.5,
                                         "train_dice": 0.4, "uncertainty_alpha": 1.0})
    return best, write_monuseg_tree(d / "M", n_train=1, n_val=2, size=64)


def test_readers_take_a_jax_best_directory(jax_best, tmp_path):
    best, tree = jax_best
    x = np.random.default_rng(2).random((2, 32, 32, 3), dtype=np.float32)
    got = Predictor(str(best), dtype=torch.float32, buckets=(2,), device="cpu")(x)
    want = JaxPredictor(str(best), dtype=jnp.float32, buckets=(2,))(x)
    _maps_match((got[1], got[0], got[2]), (want[1], want[0], want[2]))
    ev, jax_ev = MoNuSegEvaluator(str(best), device="cpu"), JaxEvaluator(str(best))
    assert ev.stage == jax_ev.stage == 1 and ev.metadata["val_dice"] == 0.5
    ds = MoNuSegDataset(str(tree), image_size=ev.resolution, split="val", augment=False)
    images = np.stack([ds[i][0] for i in range(2)])
    _maps_match(ev.predict_batch(images), jax_ev.predict_batch(images))
    want_metrics = jax_ev.evaluate_dataset(ds, batch_size=2)
    res = test_monuseg.main(["--model", str(best), "--data", str(tree), "--eval_full",
                             "--output_dir", str(tmp_path / "eval"), "--device", "cpu"])
    _metrics_match(res["metrics"], want_metrics)


# ---------------------------------------------------------------- forms
def test_orbax_and_incomplete_directories(tmp_path):
    """An orbax save that never committed (its tree still in
    ``variables_orbax.orbax-checkpoint-tmp``) is no checkpoint; saved again
    with ``backend="orbax"``, ported since, the directory is one and reads
    back as the model's state.  A directory with neither tree is none."""
    orbax = tmp_path / "ug_pgunet_stage2_last"
    (orbax / "variables_orbax.orbax-checkpoint-tmp").mkdir(parents=True)
    (orbax / "metadata.json").write_text(json.dumps({"stage": 2, "epoch": 3}))
    assert not has_checkpoint(orbax) and find_checkpoint(tmp_path, orbax.name) is None
    for call in (read_checkpoint, load_checkpoint):
        with pytest.raises(FileNotFoundError, match="variables_orbax"):
            call(orbax)
    model = STAGE_MODELS[2](num_classes=1, use_bn=True, width=W)
    save_checkpoint(orbax, model.state_dict(), backend="orbax", stage=2, epoch=3)
    assert sorted(p.name for p in orbax.iterdir()) == ["metadata.json", "variables_orbax"]
    assert has_checkpoint(orbax) and find_checkpoint(tmp_path, orbax.name) == orbax
    stage, sd = load_checkpoint(orbax)
    assert stage == 2
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):  # flax has no counter
            assert torch.equal(sd[k], v), k
    bare = tmp_path / "empty"
    bare.mkdir()
    assert not has_checkpoint(bare) and latest_checkpoint(tmp_path, "empty") is None
    with pytest.raises(FileNotFoundError, match="variables.msgpack"):
        read_checkpoint(bare)


def test_both_forms_of_one_name_take_the_later_epoch(tmp_path):
    model = STAGE_MODELS[1](num_classes=1, use_bn=True, width=W)
    sd = model.state_dict()
    name = "ug_pgunet_stage1_last"
    save_checkpoint(tmp_path / f"{name}.pth", sd, stage=1, epoch=5)
    folder = save_checkpoint(tmp_path / name, sd, backend="msgpack", stage=1, epoch=3)
    assert find_checkpoint(tmp_path, name) == tmp_path / f"{name}.pth"
    save_checkpoint(folder, sd, backend="msgpack", stage=1, epoch=6)
    assert find_checkpoint(tmp_path, name) == folder
    (folder / "metadata.json").unlink()  # a directory without it is not whole
    assert has_checkpoint(folder) and find_checkpoint(tmp_path, name) == tmp_path / f"{name}.pth"
    assert sniff_stage(folder) == 4  # no metadata: the reference's default
    time.sleep(0.01)
    save_checkpoint(tmp_path / "ug_pgunet_stage1_best", sd, backend="msgpack", stage=1)
    assert latest_checkpoint(tmp_path, "ug_pgunet") == tmp_path / "ug_pgunet_stage1_best"
    assert latest_checkpoint(tmp_path, "nothing") is None
    # read back as the .pth reads: the same weights, num_batches_tracked 0
    obj = read_checkpoint(tmp_path / "ug_pgunet_stage1_best")
    assert obj["stage"] == 1 and set(obj["model_state_dict"]) == set(sd)
    for k, v in sd.items():
        want = torch.zeros_like(v) if k.endswith("num_batches_tracked") else v
        assert torch.equal(obj["model_state_dict"][k], want), k
