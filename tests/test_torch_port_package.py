"""Package rules of ugpg_tpu_torch: it imports neither JAX nor ugpg_tpu nor PIL
(the serving stack, the MoNuSeg tools and the mesh modules included), nor
matplotlib when a module is imported (the plots import it inside), its
entry points need CUDA unless the CPU is asked for, and the trainer and
command-line options not ported yet raise (or exit "not ported") instead
of being ignored; the options ported since run: the trainers' and the
training commands' only beside a mesh raise (or exit 2), the serving mesh
options only for a mesh without a 'data' axis or across hosts."""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import ugpg_tpu_torch
from tests.test_data_monuseg import write_monuseg_tree
from ugpg_tpu_torch.cli import export_model, parse_mesh, serve, test_monuseg, train_monuseg
from ugpg_tpu_torch.data.synthetic import ArrayLoader, disk_dataset
from ugpg_tpu_torch.device import resolve_device
from ugpg_tpu_torch.eval.exported import ExportedPredictor
from ugpg_tpu_torch.eval.herlev import HerlevEvaluator
from ugpg_tpu_torch.eval import monuseg as MoNuSegEvaluator_module
from ugpg_tpu_torch.eval.monuseg import MoNuSegEvaluator
from ugpg_tpu_torch.eval.serving import Predictor
from ugpg_tpu_torch.eval.slide import ExportedSlidePredictor, SlidePredictor
from ugpg_tpu_torch.io.checkpoint import (
    full_classifier_state_dict,
    load_checkpoint,
    read_checkpoint,
    save_checkpoint,
)
from ugpg_tpu_torch.models.classifier import HerlevClassificationModel
from ugpg_tpu_torch.models.pgunet import PGUNet1
from ugpg_tpu_torch.parallel.mesh import make_mesh
from ugpg_tpu_torch.train import aug_trainer
from ugpg_tpu_torch.train.cls_trainer import HerlevTrainer, create_config
from ugpg_tpu_torch.train.seg_trainer import UncertaintyGuidedProgressiveTrainer
from ugpg_tpu_torch.utils.preemption import PreemptionGuard

PKG = pathlib.Path(ugpg_tpu_torch.__file__).parent
ROOT = PKG.parent


def test_imports_with_jax_and_ugpg_tpu_blocked():
    code = (
        "import pkgutil, sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'ugpg_tpu', 'PIL', 'matplotlib'):\n"
        "    sys.modules[name] = None  # any import of them raises ImportError\n"
        "import ugpg_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(ugpg_tpu_torch.__path__, 'ugpg_tpu_torch.')]\n"
        "for name in names:\n"
        "    __import__(name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', 'ugpg_tpu',\n"
        "                                                    'PIL', 'matplotlib')\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print(' '.join(names))\n"
        "print(len(names))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 80  # every module of the package was imported
    imported = proc.stdout.split()[:-1]
    for name in ("utils.tb", "utils.config", "parallel", "parallel.pipeline", "parallel.mesh",
                 "parallel.spatial", "parallel.tensor", "parallel.distributed",
                 "io.torch_export", "io.torch_import", "cli.export_torch", "cli.import_torch"):
        assert f"ugpg_tpu_torch.{name}" in imported, name


_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|flax|optax|msgpack|orbax|tensorstore|zstandard|PIL)\b"
    r"|\bugpg_tpu\.|\bugpg_tpu\s+import\b|import_module\(\s*['\"]ugpg_tpu['\".]",
    re.MULTILINE,
)


def test_source_names_no_jax_and_no_ugpg_tpu_module():
    hits = []
    for path in sorted(PKG.rglob("*.py")):
        for m in _FORBIDDEN.finditer(path.read_text()):
            hits.append(f"{path.relative_to(ROOT)}: {m.group(0).strip()}")
    assert not hits, hits
    # the pattern does catch what it must, and spares the port's own name
    assert _FORBIDDEN.search("from ugpg_tpu.ops import resize")
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert _FORBIDDEN.search("    from PIL import Image")
    assert not _FORBIDDEN.search("from ugpg_tpu_torch.ops import resize")
    assert _FORBIDDEN.search("import msgpack")
    assert _FORBIDDEN.search("  import orbax.checkpoint as ocp")
    assert not _FORBIDDEN.search("from ugpg_tpu_torch.io.msgpack import to_bytes")


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Predictor(str(tmp_path / "never_read.pth"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        UncertaintyGuidedProgressiveTrainer()
    for entry in (MoNuSegEvaluator, SlidePredictor, HerlevEvaluator, ExportedPredictor,
                  ExportedSlidePredictor):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            entry(str(tmp_path / "never_read.pth"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        HerlevTrainer(create_config())
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.fixture
def one_torch_thread():
    """One torch thread for a test that trains: the suite runs six test
    processes at once, where torch's default of a thread per core
    oversubscribes the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.mark.parametrize("kwargs", [
    dict(quantize=True, mesh=object()), dict(mesh=object()), dict(shard_model=True),
])
def test_options_outside_the_slice_raise(kwargs, stage1_pth):
    """The mesh options, ported since: a mesh without a 'data' axis raises
    (before the checkpoint is read, before quantize's calibration check),
    and shard_model without a mesh serves as without it, as in JAX."""
    if "mesh" in kwargs:
        with pytest.raises(ValueError, match="'data' axis"):
            Predictor(str(stage1_pth.parent / "never_read.pth"), device="cpu", **kwargs)
        return
    x = np.random.default_rng(0).random((1, 32, 32, 3), dtype=np.float32)
    for got, want in zip(Predictor(str(stage1_pth), buckets=(1,), device="cpu", **kwargs)(x),
                         Predictor(str(stage1_pth), buckets=(1,), device="cpu")(x)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kwargs", [
    dict(mesh=2), dict(shard_model=True), dict(axis_name="data"),
    dict(checkpoint_backend="msgpack"), dict(scan_epochs=True), dict(scan_chunk_bytes=1 << 30),
    dict(tb_logdir="tb"), dict(remat=True), dict(pipeline_unc=1),
])
def test_trainer_options_outside_the_slice_raise(kwargs, tmp_path, monkeypatch,
                                               one_torch_thread):
    """tb_logdir, remat and pipeline_unc, ported since, train two stages;
    beside a mesh pipeline_unc raises the JAX package's ValueError, the
    others build.  mesh (the CPU named twice) and shard_model (without a
    mesh it acts on nothing, as in JAX), ported since, train two stages;
    axis_name raises JAX's unbound-axis NameError at the first train step
    and validates.  scan_epochs and scan_chunk_bytes, ported since, train
    two stages (scan_epochs through the whole-epoch path, the cap alone
    through the per-step path).  checkpoint_backend="msgpack", ported
    since, trains two stages into the JAX package's directories; the orbax
    backends, ported since, write the trained stage's ``_last`` as orbax
    directories that read back as the model's state."""
    if set(kwargs) & {"tb_logdir", "remat", "pipeline_unc", "mesh", "shard_model",
                      "axis_name", "scan_epochs", "scan_chunk_bytes", "checkpoint_backend"}:
        monkeypatch.setitem(sys.modules, "tensorflow", None)
        kw = {k: (tmp_path / v if k == "tb_logdir" else v) for k, v in kwargs.items()}
        if "mesh" in kw:
            kw["mesh"] = make_mesh(kw["mesh"], devices=["cpu"] * kw["mesh"])
        images, masks = disk_dataset(num_samples=2, image_size=16, seed=0)
        loader = ArrayLoader(images, masks, batch_size=2)
        cfgs = {s: {"resolution": 16, "epochs_per_stage": 1, "lr": 3e-4} for s in (1, 2)}
        tr = UncertaintyGuidedProgressiveTrainer(device="cpu", verbose=False, width=0.25,
                                                 stage_configs=cfgs, **kw)
        if "axis_name" in kw:
            with pytest.raises(NameError, match="unbound axis name: data"):
                tr.train_epoch(loader, 1)
            assert np.isfinite(tr.validate_epoch(loader, 1)[0])
            return
        h = tr.train_progressive(loader, loader, max_stages=2, save_dir=tmp_path / "out")
        assert len(h["train_loss"]) == 2 and np.isfinite(h["train_loss"]).all()
        if "tb_logdir" in kw:
            assert list(kw["tb_logdir"].glob("events.out.tfevents.*"))
        assert tr.models[2].inc.conv.remat == ("remat" in kw)
        assert list(tr._pipelines) == ([2] if "pipeline_unc" in kw else [])
        assert ((2, "mesh") in tr._train_steps) == ("mesh" in kw)
        assert (list(tr._epochs) == [(2, "train", False), (2, "eval", False)]) == (
            "scan_epochs" in kw)
        assert tr.scan_chunk_bytes == kw.get("scan_chunk_bytes", 1 << 30)
        msgpack = "checkpoint_backend" in kw
        for stage in (1, 2):
            assert (tmp_path / "out" / f"ug_pgunet_stage{stage}_best.pth").is_file() != msgpack
            assert (tmp_path / "out" / f"ug_pgunet_stage{stage}_best" / "variables.msgpack"
                    ).is_file() == msgpack
        if msgpack:
            want = tr.models[2].state_dict()
            for backend in ("orbax", "orbax-async"):
                assert UncertaintyGuidedProgressiveTrainer(
                    device="cpu", verbose=False, checkpoint_backend=backend
                ).checkpoint_backend == backend
                tr.checkpoint_backend = backend
                last = tr._checkpoint(tmp_path / backend, "ug_pgunet_stage2_last", 2, 0)
                got = read_checkpoint(last)  # waits for the async save
                assert sorted(p.name for p in last.iterdir()) == [
                    "metadata.json", "opt_state_orbax", "variables_orbax"]
                assert got["stage"] == 2 and got["epoch"] == 0
                for k, v in want.items():
                    if not k.endswith("num_batches_tracked"):  # flax has no counter
                        assert torch.equal(got["model_state_dict"][k], v), k
        if "mesh" in kw or "shard_model" in kw:
            return
        mesh = make_mesh(2, devices=["cpu"] * 2)
        if "pipeline_unc" in kw:
            with pytest.raises(ValueError, match="mutually exclusive"):
                UncertaintyGuidedProgressiveTrainer(device="cpu", verbose=False, mesh=mesh, **kw)
        else:
            UncertaintyGuidedProgressiveTrainer(device="cpu", verbose=False, mesh=mesh, **kw)
        return


@pytest.mark.parametrize("call", ["finetune_native"])
def test_trainer_calls_outside_the_slice_raise(call, tmp_path):
    """finetune_native, ported since, needs a mesh: without one the JAX
    package's ValueError (it runs in tests/test_torch_spatial_train.py)."""
    tr = UncertaintyGuidedProgressiveTrainer(device="cpu", verbose=False)
    with pytest.raises(ValueError, match="needs a mesh"):
        tr.finetune_native([])


@pytest.fixture(scope="module")
def stage1_pth(tmp_path_factory):
    path = tmp_path_factory.mktemp("pkg") / "stage1.pth"
    torch.manual_seed(0)
    save_checkpoint(path, PGUNet1(use_bn=True).state_dict(), stage=1, epoch=0)
    return path


@pytest.mark.parametrize("option", ["dtype=bfloat16", "resume", "preemption", "fold_bn=False",
                                    "task_type=classification", "mc_dropout=4"])
def test_options_ported_since_run(option, stage1_pth, tmp_path):
    """The options that raised until a later slice now run."""
    if option in ("task_type=classification", "mc_dropout=4"):
        path = tmp_path / "herlev_stage1_best.pth"
        torch.manual_seed(0)
        save_checkpoint(path, full_classifier_state_dict(
            HerlevClassificationModel(1, 7).state_dict(), 1), stage=1, epoch=0)
        mc = 4 if option == "mc_dropout=4" else 0
        outs = Predictor(str(path), buckets=(2,), dtype=torch.float32, num_classes=7,
                         task_type="classification", mc_dropout=mc, device="cpu")(
            np.zeros((2, 40, 40, 3), np.float32))
        assert len(outs) == (3 if mc else 2) and outs[1].shape == (2, 7)
        np.testing.assert_allclose(outs[1].sum(-1), 1.0, atol=1e-5)
        return
    if option == "fold_bn=False":
        preds, probs, unc = Predictor(str(stage1_pth), buckets=(1,), dtype=torch.float32,
                                      fold_bn=False, device="cpu")(np.zeros((1, 32, 32, 3)))
        assert probs.shape == (1, 32, 32, 1) and np.isfinite(probs).all()
        return
    images, masks = disk_dataset(num_samples=2, image_size=16, seed=0)
    loader = ArrayLoader(images, masks, batch_size=2)
    cfgs = {1: {"resolution": 16, "epochs_per_stage": 1, "lr": 3e-4}}
    kwargs = {"resume": dict(resume=True), "preemption": dict(preemption=PreemptionGuard()),
              "dtype=bfloat16": {}}[option]
    tr = UncertaintyGuidedProgressiveTrainer(
        device="cpu", verbose=False, width=0.25, stage_configs=cfgs,
        dtype=torch.bfloat16 if option == "dtype=bfloat16" else None)
    h = tr.train_progressive(loader, loader, max_stages=1, save_dir=tmp_path, **kwargs)
    assert len(h["train_loss"]) == 1 and not tr.preempted


@pytest.mark.parametrize("part", ["mesh", "w_axis", "export"])
def test_slide_predictor_parts_outside_the_slice_raise(part, stage1_pth, tmp_path):
    """Ported since: mesh and w_axis shard the slide (H over 'data', W over
    the w_axis) and answer as the unsharded predictor where no padding
    differs; w_axis without a mesh raises; export writes an artifact."""
    x = np.random.default_rng(0).random((1, 32, 32, 3), dtype=np.float32)
    live = SlidePredictor(str(stage1_pth), device="cpu")
    if part == "export":
        art = live.export(tmp_path / "slide", sizes=((32, 32),))
        for got, want in zip(ExportedSlidePredictor(art, device="cpu")(x), live(x)):
            np.testing.assert_array_equal(got, want)
        return
    shape, w_axis = ((2, 1), None) if part == "mesh" else ((2, 2), "model")
    mesh = make_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))
    sharded = SlidePredictor(str(stage1_pth), device="cpu", mesh=mesh, w_axis=w_axis)
    for got, want in zip(sharded(x), live(x)):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    if part == "w_axis":
        with pytest.raises(ValueError, match="mesh"):
            SlidePredictor(str(stage1_pth), device="cpu", w_axis="model")


def test_parts_still_to_port_cite_their_roadmap_items(monkeypatch):
    """The last multi-device parts (ROADMAP.md queue A, item 4b.4: the
    multi-process --mesh over parallel/distributed.py; item 4b.5: the
    pipeline's multi-device groups) are ported: ROADMAP.md marks both
    done, the pipeline builds a mesh per group, ``--mesh`` under a
    coordinator joins the processes, and no message of the port cites
    either item as still to port."""
    import torch.distributed as dist

    from ugpg_tpu_torch.parallel import mesh as port_mesh
    from ugpg_tpu_torch.parallel.pipeline import pipeline_devices

    roadmap = (ROOT / "ROADMAP.md").read_text()
    assert re.search(r"4b\.4[^\n]*done", roadmap) and re.search(r"4b\.5[^\n]*done", roadmap)
    cpus = [torch.device("cpu", i) for i in range(3)]
    train, unc = pipeline_devices(1, cpus)  # a train group of two devices
    assert train.shape == {"data": 2, "model": 1} and unc.shape == {"data": 1, "model": 1}
    train, unc = pipeline_devices(2, cpus)  # an unc group of two
    assert train.shape == {"data": 1, "model": 1} and unc.shape == {"data": 2, "model": 1}
    train, _ = pipeline_devices(1, ["cpu"] * 3, n_model=2)
    assert train.shape == {"data": 1, "model": 2}
    assert "item 4b.4" not in port_mesh.__doc__
    for path in PKG.rglob("*.py"):
        assert not re.search(r"item 4b\.[45]", path.read_text()), path
    called = []
    monkeypatch.setattr(dist, "init_process_group", lambda **kw: called.append(kw))
    monkeypatch.setenv("UGPG_COORDINATOR_ADDRESS", "localhost:1234")
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert parse_mesh("2", "cpu").shape == {"data": 2, "model": 1}
    assert called[0]["init_method"] == "tcp://localhost:1234" and called[0]["world_size"] == 2


class _StubTrainer:
    """Stands in for ``AugMoNuSegTrainer``: keeps its keyword arguments,
    trains nothing, records ``finetune_native``'s call."""

    def __init__(self, config, **kwargs):
        self.kwargs, self.mesh, self.preempted, self.native = kwargs, kwargs.get("mesh"), False, None
        self.stage_configs = {s: {"resolution": 16} for s in (1, 2, 3, 4)}

    def setup_datasets(self, *a, **k):
        pass

    def make_loaders(self, **k):
        return {}, {}

    def train_progressive(self, *a, **k):
        pass

    def finetune_native(self, loader, **kwargs):
        self.native = kwargs


@pytest.mark.parametrize("command,flags", [
    ("train", ["--mesh", "4,2"]), ("train", ["--scan_epochs"]),
    ("train", ["--scan_chunk_mb", "512"]), ("train", ["--tb_logdir", "tb"]),
    ("train", ["--remat"]), ("train", ["--pipeline_unc", "1"]),
    ("train", ["--native_finetune", "1"]), ("train", ["--checkpoint_backend", "msgpack"]),
    ("train", ["--checkpoint_backend", "orbax-async"]), ("test", ["--mesh", "2,2"]),
    ("serve", ["--mesh", "2"]), ("export", ["--quantize"]), ("export", ["--platforms", "tpu"]),
])
def test_command_flags_outside_the_slice_exit_not_ported(command, flags, tmp_path, capsys,
                                                        monkeypatch):
    """Never ignored: the command exits 2 naming the flag.  Ported since:
    --tb_logdir, --remat, --pipeline_unc, --scan_epochs and --scan_chunk_mb
    (MiB, as the trainer's scan_chunk_bytes) reach the trainer, and beside
    --mesh --pipeline_unc exits 2 with the JAX package's ValueError; --mesh
    of train, test and serve builds the mesh; under a coordinator train
    joins the processes first (no rendezvous here: ``init_process_group``
    records its call, and without a process count the command exits 2
    before any), test evaluates on its own mesh without joining, as the JAX
    command does, and serve exits 2 naming --mesh and the JAX fetch that
    refuses it; --native_finetune fine-tunes the last stage over the mesh
    (native size, the W axis) and without --mesh exits with JAX's message.
    --checkpoint_backend msgpack and orbax-async, ported since, reach the
    trainer."""
    import torch.distributed as dist

    joined = []
    monkeypatch.setattr(dist, "init_process_group", lambda **kw: joined.append(kw))
    if command == "train":
        argv = ["--data_dir", str(tmp_path), "--output_dir", str(tmp_path / "out"),
                "--device", "cpu", *flags]
        main = train_monuseg.main
        if flags[0] in ("--tb_logdir", "--remat", "--pipeline_unc", "--mesh",
                        "--native_finetune", "--scan_epochs", "--scan_chunk_mb",
                        "--checkpoint_backend"):
            real = aug_trainer.AugMoNuSegTrainer
            monkeypatch.setattr(aug_trainer, "AugMoNuSegTrainer", _StubTrainer)
            if flags[0] == "--native_finetune":
                write_monuseg_tree(tmp_path)
                with pytest.raises(SystemExit, match="--native_finetune requires --mesh"):
                    main(argv)
                tr = main(argv + ["--mesh", "2", "--native_w_axis", "--native_size", "48",
                                  "--stages", "1", "2"])
                assert tr.native["stage"] == 2 and tr.native["epochs"] == 1
                assert tr.native["w_axis"] == "model"
                assert tr.native["val_loader"].dataset.image_size == 48
                return
            if flags[0] == "--mesh":
                assert main(argv).kwargs["mesh"].shape == {"data": 4, "model": 2}
                monkeypatch.setenv("UGPG_COORDINATOR_ADDRESS", "localhost:1234")
                monkeypatch.setenv("WORLD_SIZE", "2")
                monkeypatch.setenv("RANK", "1")
                assert main(argv).kwargs["mesh"].shape == {"data": 4, "model": 2}
                assert joined == [{"backend": "gloo", "init_method": "tcp://localhost:1234",
                                   "world_size": 2, "rank": 1, "timeout": joined[0]["timeout"]}]
                monkeypatch.delenv("WORLD_SIZE")
                joined.clear()
            else:
                key, want = {"--tb_logdir": ("tb_logdir", "tb"), "--remat": ("remat", True),
                             "--pipeline_unc": ("pipeline_unc", 1),
                             "--scan_epochs": ("scan_epochs", True),
                             "--scan_chunk_mb": ("scan_chunk_bytes", 512 << 20),
                             "--checkpoint_backend": ("checkpoint_backend", flags[-1])}[flags[0]]
                assert main(argv).kwargs[key] == want
                mesh_kwargs = main(argv + ["--mesh", "2"]).kwargs
                assert mesh_kwargs["mesh"].shape == {"data": 2, "model": 1}
                if key != "pipeline_unc":
                    return
                monkeypatch.setattr(aug_trainer, "AugMoNuSegTrainer", real)
                argv, flags = argv + ["--mesh", "2"], ["mutually exclusive"]
    elif command == "serve":
        argv = ["--model", f"m={tmp_path / 'm.pth'}", "--device", "cpu", *flags]
        main = serve.main
        monkeypatch.setenv("UGPG_COORDINATOR_ADDRESS", "localhost:1234")
    elif command == "export":
        argv = ["--model", str(tmp_path / "m.pth"), "--out", str(tmp_path), "--device", "cpu",
                *flags]
        main = export_model.main
    else:
        argv = ["--model", str(tmp_path / "m.pth"), "--eval_full", "--native_res",
                "--device", "cpu", *flags]
        assert parse_mesh("2,2", "cpu").shape == {"data": 2, "model": 2}
        monkeypatch.setenv("UGPG_COORDINATOR_ADDRESS", "localhost:1234")
        monkeypatch.setenv("WORLD_SIZE", "2")

        class Reached(Exception):
            pass

        def evaluator(*a, **k):  # the mesh is built: stop before loading the model
            raise Reached

        monkeypatch.setattr(MoNuSegEvaluator_module, "MoNuSegEvaluator", evaluator)
        with pytest.raises(Reached):
            test_monuseg.main(argv)
        assert joined == []  # each process evaluates alone, as the JAX command
        return
    with pytest.raises(SystemExit) as info:
        main(argv)
    err = capsys.readouterr().err
    # --quantize is ported, but never without its calibration images
    missing = {"--quantize": "requires --calibration", "mutually exclusive": "",
               "--mesh": {"train": "no process count",
                          "serve": "ugpg_tpu/eval/serving.py:473"}.get(command)}.get(
        flags[0], "not ported")
    assert info.value.code == 2 and missing in err and flags[0] in err
    assert joined == []


def test_load_checkpoint_container_and_bare_state_dict(tmp_path):
    sd = {"outc.conv.weight": torch.ones(1, 8, 1, 1)}
    torch.save({"stage": 2, "epoch": 3, "model_state_dict": sd}, tmp_path / "c.pth")
    torch.save(sd, tmp_path / "bare.pth")
    stage, got = load_checkpoint(tmp_path / "c.pth")
    assert stage == 2 and torch.equal(got["outc.conv.weight"], sd["outc.conv.weight"])
    assert load_checkpoint(tmp_path / "bare.pth")[0] == 4  # the reference's default
