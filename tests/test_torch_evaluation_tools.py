"""The port's evaluation tools and utilities against the JAX package's, on
the CPU: the evaluation index generator and its video expansion, the
offline `MetricComputer`, the `compute_metrics` and
`generate_evaluation_index` scripts end to end on the repo's fixture, the
shape checks at their call sites, `fig_to_image`, the wandb logger, and the
pretrained-trunk graft (`interop/pretrained.py`) with `init_state`.

Tolerances: the indices are equal (both packages take the same
`default_rng` draws in the same order, and each overlap is a mean of
booleans compared with the same bounds); PSNR and SSIM to 1e-5 (float32
over the same 8-bit PNGs), the scripts' PSNR at 256x256 to
SCRIPT_PSNR_ATOL_DB; `fig_to_image` and the grafted tensors equal.
"""

import dataclasses
import json
import sys
import types
from dataclasses import dataclass, field
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelsplat_tpu.evaluation import evaluation_index_generator as jx_index
from pixelsplat_tpu.evaluation import metric_computer as jx_mc
from pixelsplat_tpu.evaluation.evaluation_cfg import EvaluationCfg as JxEvaluationCfg
from pixelsplat_tpu.evaluation.evaluation_cfg import MethodCfg as JxMethodCfg
from pixelsplat_tpu.interop import pretrained as jx_pretrained
from pixelsplat_tpu.interop import torch_import
from pixelsplat_tpu.model.encoder.backbone import dino as jx_dino
from pixelsplat_tpu.scripts import compute_metrics as jx_compute_metrics
from pixelsplat_tpu.scripts import generate_evaluation_index as jx_generate
from pixelsplat_tpu.utils import image_io as jx_image_io
from pixelsplat_tpu_torch import config as pt_config
from pixelsplat_tpu_torch.dataset.data_module import DataModule
from pixelsplat_tpu_torch.evaluation import evaluation_index_generator as pt_index
from pixelsplat_tpu_torch.evaluation.evaluation_cfg import EvaluationCfg, MethodCfg
from pixelsplat_tpu_torch.evaluation.metric_computer import MetricComputer
from pixelsplat_tpu_torch.interop import from_jax
from pixelsplat_tpu_torch.interop import pretrained as pt_pretrained
from pixelsplat_tpu_torch.model.encoder.backbone import dino as pt_dino
from pixelsplat_tpu_torch.model.encoder.backbone import resnet as pt_resnet
from pixelsplat_tpu_torch.model.encoder.encoder_epipolar import EncoderEpipolar as PtEncoder
from pixelsplat_tpu_torch.ops.rasterizer.render import render
from pixelsplat_tpu_torch.scripts import compute_metrics as pt_compute_metrics
from pixelsplat_tpu_torch.scripts import generate_evaluation_index as pt_generate
from pixelsplat_tpu_torch.scripts import generate_video_evaluation_index as pt_video_index
from pixelsplat_tpu_torch.training.model_wrapper import ModelWrapper
from pixelsplat_tpu_torch.utils import image_io as pt_image_io
from pixelsplat_tpu_torch.utils import shape_checks, wandb_tools
from pixelsplat_tpu_torch.utils.local_logger import LocalLogger

import test_torch_encoder as enc_helpers

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "fixtures"
METRIC_ATOL = 1e-5
# The scripts' PSNR at the fixture's 256x256: each side's float32 mean of
# 196,608 squared differences, summed in another order, lies ~1e-5 relative
# from the other's, which is 10 / ln 10 x 1e-5 = 4.3e-5 dB (measured 4.0e-5).
SCRIPT_PSNR_ATOL_DB = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# The evaluation index


def dolly(v=24):
    """`tests/test_evaluation_tools.py`'s linear dolly: overlap falls with distance."""
    extrinsics = np.tile(np.eye(4, dtype=np.float32), (v, 1, 1))
    extrinsics[:, 0, 3] = np.arange(v) * 0.15
    intrinsics = np.tile(np.array([[1.2, 0, 0.5], [0, 1.2, 0.5], [0, 0, 1]], np.float32), (v, 1, 1))
    return extrinsics, intrinsics


def turning(v=8):
    """Cameras at one point, each turned 100 degrees from the last: no two overlap."""
    extrinsics = np.tile(np.eye(4, dtype=np.float32), (v, 1, 1))
    th = np.deg2rad(100.0 * np.arange(v))
    extrinsics[:, 0, 0], extrinsics[:, 0, 2] = np.cos(th), np.sin(th)
    extrinsics[:, 2, 0], extrinsics[:, 2, 2] = -np.sin(th), np.cos(th)
    return extrinsics, dolly(v)[1]


@pytest.mark.parametrize("seed", [0, 5])
def test_index_generator_matches_jax_on_the_dolly(tmp_path, seed):
    cfgs = [
        module.EvaluationIndexGeneratorCfg(
            num_target_views=3, min_distance=3, max_distance=12, min_overlap=0.2, max_overlap=1.0,
            output_path=tmp_path / name, seed=seed,
        )
        for module, name in ((jx_index, "jax"), (pt_index, "port"))
    ]
    jx_gen, pt_gen = jx_index.EvaluationIndexGenerator(cfgs[0]), pt_index.EvaluationIndexGenerator(cfgs[1])
    extrinsics, intrinsics = dolly()
    fast = extrinsics.copy()
    fast[:, 0, 3] *= 2
    for scene, (e, k) in (("scene_a", (extrinsics, intrinsics)), ("scene_b", (fast, intrinsics)),
                          ("scene_far", turning())):
        jx_gen.process_scene(scene, e, k, (16, 16))
        pt_gen.process_scene(scene, e, k, (16, 16))
    assert pt_gen.index["scene_far"] is None and pt_gen.index["scene_a"] is not None
    paths = [jx_gen.save_index(), pt_gen.save_index()]
    assert json.loads(paths[1].read_text()) == json.loads(paths[0].read_text())
    left, right = pt_gen.index["scene_a"].context
    assert 3 <= right - left <= 13 and len(set(pt_gen.index["scene_a"].target)) == 3

    # The video index: every frame between the context views is a target.
    jx_index.expand_to_video_index(paths[0], tmp_path / "jax_video.json")
    assert pt_video_index.main([str(paths[1]), str(tmp_path / "port_video.json")]) == tmp_path / "port_video.json"
    video = json.loads((tmp_path / "port_video.json").read_text())
    assert video == json.loads((tmp_path / "jax_video.json").read_text())
    assert video["scene_a"]["target"] == list(range(left, right + 1)) and video["scene_far"] is None


def fixture_index_argv(out: Path) -> list[str]:
    return ["dataset.roots=[tests/fixtures/re10k]", "data_loader.test.num_workers=0",
            *pt_generate.FIXTURE_OVERRIDES, f"index_generator.output_path={out}"]


def test_generate_evaluation_index_script_matches_jax(tmp_path, monkeypatch):
    """Both packages' scripts over the fixture's test scenes: the same file,
    with an entry for each scene."""
    monkeypatch.chdir(ROOT)
    pt_path = pt_generate.main(fixture_index_argv(tmp_path / "port"), device="cpu")
    jx_generate.main(fixture_index_argv(tmp_path / "jax"))
    got = json.loads(pt_path.read_text())
    assert got == json.loads((tmp_path / "jax" / "evaluation_index.json").read_text())
    assert sorted(got) == ["fixture_scene_a", "fixture_scene_b"] and all(got.values())


# ---------------------------------------------------------------------------
# Metrics of rendered PNGs


def write_method(root: Path, scene: str, gt: np.ndarray, indices, seed: int, noise: float = 0.02) -> None:
    rng = np.random.default_rng(seed)
    for image, idx in zip(gt, indices):
        noisy = np.clip(image + noise * rng.standard_normal(image.shape), 0, 1).astype(np.float32)
        pt_image_io.save_image(noisy, root / scene / "color" / f"{idx:0>6}.png")


def test_metric_computer_matches_jax(tmp_path, monkeypatch):
    # The JAX computer scores LPIPS with random VGG weights; the port's
    # scores LPIPS only with the exported weights, absent here.
    monkeypatch.setattr(jx_mc, "get_lpips_params", lambda: (None, False))
    monkeypatch.setattr(jx_mc, "compute_lpips", lambda gt, hat, params: jnp.zeros(gt.shape[0]))
    gt = np.random.default_rng(0).uniform(0, 1, (3, 3, 64, 64)).astype(np.float32)
    for key, seed, noise in (("ours", 1, 0.02), ("other", 2, 0.1)):
        write_method(tmp_path / key, "scene_x", gt, [4, 9, 11], seed, noise)
    methods = [("Ours", "ours"), ("Other", "other")]
    jx = jx_mc.MetricComputer(JxEvaluationCfg(methods=tuple(JxMethodCfg(n, k, tmp_path / k) for n, k in methods)))
    pt = MetricComputer(EvaluationCfg(methods=tuple(MethodCfg(n, k, tmp_path / k) for n, k in methods),
                                      side_by_side_path=tmp_path / "side"))
    assert not pt.lpips_pretrained
    result = pt.process_scene("scene_x", gt, [4, 9, 11])
    jx.process_scene("scene_x", gt, [4, 9, 11])
    for _, key in methods:
        for metric in ("psnr", "ssim"):
            got, want = pt.scores[key][metric], jx.scores[key][metric]
            assert len(got) == 3
            np.testing.assert_allclose(got, want, rtol=0, atol=METRIC_ATOL, err_msg=f"{key} {metric}")
        assert pt.scores[key]["lpips"] == [] and "lpips" not in result[key]
    assert result["ours"]["psnr"] > 25 > result["other"]["psnr"] and 0 < result["ours"]["ssim"] <= 1
    assert sorted(p.name for p in (tmp_path / "side" / "scene_x").iterdir()) == ["000004.png", "000009.png", "000011.png"]
    # A scene a method lacks a frame of is skipped and scores nothing.
    assert pt.process_scene("scene_missing", gt[:1], [1]) is None
    assert len(pt.scores["ours"]["psnr"]) == 3
    pt.print_preview()
    assert pt.summary() == result


def test_compute_metrics_script_matches_jax(tmp_path, monkeypatch):
    """Both packages' `compute_metrics` over the fixture's scenes under its
    evaluation index, scoring PNGs made from the ground truth."""
    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(jx_mc, "get_lpips_params", lambda: (None, False))
    monkeypatch.setattr(jx_mc, "compute_lpips", lambda gt, hat, params: jnp.zeros(gt.shape[0]))
    base = ["dataset.roots=[tests/fixtures/re10k]", "data_loader.test.num_workers=0",
            "dataset.view_sampler.index_path=tests/fixtures/evaluation_index_fixture.json"]
    cfg = pt_config.load_typed_root_config({
        k: v for k, v in pt_config.compose_config(base, main_name="compute_metrics").items()
        if k not in ("evaluation", "output_metrics_path", "index_generator")
    })
    scenes = 0
    for batch in DataModule(cfg.dataset, cfg.data_loader).test_dataloader():
        write_method(tmp_path / "frames", batch["scene"][0], batch["target"]["image"][0],
                     batch["target"]["index"][0].tolist(), seed=scenes)
        scenes += 1
    assert scenes == 2

    def argv(side):
        return base + [f"evaluation.methods=[{{name: Ours, key: ours, path: {tmp_path / 'frames'}}}]",
                       f"output_metrics_path={tmp_path / side / 'metrics.json'}"]

    computer = pt_compute_metrics.main(argv("port"), device="cpu")
    got = computer.summary()
    assert len(computer.scores["ours"]["psnr"]) == 6  # 3 target views of each scene
    jx_compute_metrics.main(argv("jax"))
    want = json.loads((tmp_path / "jax" / "metrics.json").read_text())
    assert json.loads((tmp_path / "port" / "metrics.json").read_text()) == got
    assert got["ours"].keys() == {"psnr", "ssim"}
    assert abs(got["ours"]["psnr"] - want["ours"]["psnr"]) <= SCRIPT_PSNR_ATOL_DB
    assert abs(got["ours"]["ssim"] - want["ours"]["ssim"]) <= METRIC_ATOL
    assert got["ours"]["psnr"] > 25


# ---------------------------------------------------------------------------
# Shape checks


def cameras(b=1, v=2):
    return torch.eye(4).repeat(b, v, 1, 1), torch.eye(3).repeat(b, v, 1, 1), torch.ones(b, v), torch.ones(b, v)


def test_shape_checks_accept_right_shapes_and_name_wrong_ones():
    shape_checks.check_cameras(*cameras())
    shape_checks.check_cameras(*(x[0] for x in cameras()), batch_dims=1)
    shape_checks.check_gaussians(torch.zeros(2, 5, 3), torch.zeros(2, 5, 3, 3), torch.zeros(2, 5, 3, 9), torch.zeros(2, 5))
    context = dict(zip(("extrinsics", "intrinsics", "near", "far"), cameras()), image=torch.zeros(1, 2, 3, 8, 8))
    shape_checks.check_context(context)
    e, k, n, f = cameras()
    for args, match in (
        ((e[..., :3], k, n, f), "extrinsics"),
        ((e, k[..., :2, :], n, f), "intrinsics"),
        ((e, k, n[..., None], f), "near"),
        ((e, k, n, f[:, :1]), "far"),
    ):
        with pytest.raises(ValueError, match=match):
            shape_checks.check_cameras(*args)
    with pytest.raises(ValueError, match="opacities"):
        shape_checks.check_gaussians(torch.zeros(2, 5, 3), torch.zeros(2, 5, 3, 3), torch.zeros(2, 5, 3, 9), torch.zeros(2, 4))
    with pytest.raises(ValueError, match="context near"):
        shape_checks.check_context(dict(context, near=torch.ones(1, 3)))


def test_shape_checks_guard_the_encoder_and_the_renderer(monkeypatch):
    monkeypatch.setitem(pt_dino.VIT_SPECS, "tiny", enc_helpers.TINY)
    _, pcfg = enc_helpers.tiny_encoder_cfgs()
    encoder = PtEncoder(pcfg).eval()
    e, k, n, f = cameras()
    context = dict(image=torch.rand(1, 2, 3, 64, 64), extrinsics=e, intrinsics=k, near=n, far=f)
    with pytest.raises(ValueError, match="context far"):
        encoder(dict(context, far=torch.ones(1, 2, 1)), 0, True)
    with pytest.raises(ValueError, match="context image"):
        encoder(dict(context, image=context["image"][0]), 0, True)
    g = 4
    gaussians = (torch.zeros(1, g, 3), torch.eye(3).expand(1, g, 3, 3) * 1e-3, torch.zeros(1, g, 3, 9), torch.ones(1, g))
    background = torch.zeros(1, 3)
    image = render(e[:, 0], k[:, 0], n[:, 0], f[:, 0], (16, 16), background, *gaussians)
    assert image.shape == (1, 3, 16, 16)
    with pytest.raises(ValueError, match="extrinsics"):
        render(e, k[:, 0], n[:, 0], f[:, 0], (16, 16), background, *gaussians)
    with pytest.raises(ValueError, match="harmonics"):
        render(e[:, 0], k[:, 0], n[:, 0], f[:, 0], (16, 16), background, *gaussians[:2], torch.zeros(1, g, 9), gaussians[3])


# ---------------------------------------------------------------------------
# fig_to_image and the wandb logger


def test_fig_to_image_matches_jax():
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(2.0, 1.5))
    ax.plot([0, 1, 2], [2, 0, 1], color="tab:red")
    ax.set_title("fig")
    try:
        got, want = pt_image_io.fig_to_image(fig), jx_image_io.fig_to_image(fig)
    finally:
        plt.close(fig)
    assert got.shape == want.shape == (3, 150, 200) and got.dtype == np.float32
    assert np.array_equal(got, want) and 0.0 < got.mean() < 1.0


@dataclass
class WandbSettings:
    project: str = "proj"
    entity: str = ""
    name: str = "run"
    mode: str = "online"
    tags: tuple = field(default_factory=tuple)


def install_fake_wandb(monkeypatch):
    """A stand-in `wandb` module recording what it is asked, as
    `tests/test_wandb_logger.py` makes for the JAX package."""
    fake = types.ModuleType("wandb")
    fake.calls = []

    class Run:
        id = "abc123"

        def __init__(self):
            self.artifacts, self.finished = [], False

        def log_artifact(self, artifact, aliases=None):
            self.artifacts.append((artifact, aliases))

        def finish(self):
            self.finished = True

    class Image:
        def __init__(self, path):
            self.path = path

    class Artifact:
        def __init__(self, name, type):
            self.name, self.type, self.files = name, type, []

        def add_file(self, path):
            self.files.append(path)

    fake.run = Run()
    fake.init = lambda **kw: fake.calls.append(("init", kw)) or fake.run
    fake.log = lambda data, step=None: fake.calls.append(("log", data, step))
    fake.Image, fake.Artifact = Image, Artifact
    monkeypatch.setitem(sys.modules, "wandb", fake)
    monkeypatch.setattr(wandb_tools, "wandb", fake)
    monkeypatch.setattr(wandb_tools, "WANDB_AVAILABLE", True)
    return fake, wandb_tools


def test_wandb_logger_through_a_fake_module(tmp_path, monkeypatch):
    fake, wt = install_fake_wandb(monkeypatch)
    logger = wt.select_logger(WandbSettings(tags=("a",)), tmp_path, config_dict={"seed": 1})
    assert isinstance(logger, wt.WandbLogger) and logger.path == tmp_path / "local"
    assert fake.calls[0][0] == "init" and fake.calls[0][1]["config"] == {"seed": 1}
    assert fake.calls[0][1]["tags"] == ["a"] and fake.calls[0][1]["entity"] is None

    logger.log_metrics({"loss": 0.5}, step=3)
    assert ("log", {"loss": 0.5}, 3) in fake.calls
    assert json.loads((tmp_path / "local" / "metrics.jsonl").read_text()) == {"step": 3, "loss": 0.5}
    logger.log_image("comparison", np.zeros((3, 8, 8), np.float32), step=3)
    assert (tmp_path / "local" / "comparison" / "000003.png").exists()
    assert any(c[0] == "log" and isinstance(c[1].get("comparison"), fake.Image) for c in fake.calls)

    checkpoint = tmp_path / "checkpoints" / "step_7"
    checkpoint.parent.mkdir()
    checkpoint.write_bytes(b"0")
    logger.log_model(checkpoint, step=7)
    artifact, aliases = fake.run.artifacts[0]
    assert artifact.type == "model" and artifact.files == [str(checkpoint)] and aliases == ["step-7"]
    logger.finish()
    assert fake.run.finished
    # Disabled, or on a rank other than 0 (`main` passes no settings), the local logger.
    assert type(wt.select_logger(WandbSettings(mode="disabled"), tmp_path / "b")) is LocalLogger
    assert type(wt.select_logger(None, tmp_path / "c")) is LocalLogger


def test_select_logger_falls_back_without_wandb(tmp_path):
    assert not wandb_tools.WANDB_AVAILABLE  # not installed here
    logger = wandb_tools.select_logger(WandbSettings(mode="online"), tmp_path)
    assert type(logger) is LocalLogger and logger.path == tmp_path / "local"
    logger.log_model(tmp_path, step=1)  # nothing to do locally
    with pytest.raises(RuntimeError, match="require the wandb package"):
        wandb_tools.update_checkpoint_path("wandb://run:v1")
    assert wandb_tools.update_checkpoint_path("a/b") == Path("a/b")


# ---------------------------------------------------------------------------
# The pretrained graft


def write_hub_weights(directory: Path, vit_model: str, vit: torch.nn.Module, resnet: torch.nn.Module) -> None:
    """Hub-layout npz files, as the JAX package's tools/export_dino_weights.py writes them."""
    pt_pretrained.save_state_dict_npz(vit.state_dict(), directory / f"{vit_model}.npz")
    pt_pretrained.save_state_dict_npz(resnet.state_dict(), directory / "dino_resnet50.npz")


def hub_modules(spec: dict, pos_grid: int, seed: int):
    """A ViT and a full four-stage BatchNorm ResNet-50 with the hub's
    parameter names (the port's own modules keep them), numpy-seeded; the
    ResNet also carries the hub's `num_batches_tracked` buffers."""
    vit = enc_helpers.randomize(pt_dino.DinoViT(spec["patch"], spec["dim"], spec["depth"], spec["heads"], pos_grid), seed)
    trunk = pt_resnet._Trunk("bottleneck", pt_resnet.RESNET_SPECS["dino_resnet50"][1], 4, "batch", None)
    trunk = enc_helpers.randomize(trunk, seed + 1)
    for name, module in list(trunk.named_modules()):
        if isinstance(module, pt_resnet.FrozenBatchNorm2d):
            module.register_buffer("num_batches_tracked", torch.tensor(7))
    return vit, trunk


@pytest.fixture
def tiny_hub(tmp_path, monkeypatch):
    monkeypatch.setitem(pt_dino.VIT_SPECS, "tiny", enc_helpers.TINY)
    monkeypatch.setitem(jx_dino.VIT_SPECS, "tiny", enc_helpers.TINY)
    monkeypatch.setattr(pt_pretrained, "WEIGHTS_DIR", tmp_path)
    monkeypatch.setattr(jx_pretrained, "WEIGHTS_DIR", tmp_path)
    jcfg, pcfg = enc_helpers.tiny_encoder_cfgs()
    vit, trunk = hub_modules(enc_helpers.TINY, pcfg.backbone.resolved_pos_grid, seed=5)
    write_hub_weights(tmp_path, "tiny", vit, trunk)
    return tmp_path, jcfg, pcfg, vit, trunk


def graft_against_jax(jcfg, pcfg, seed: int) -> tuple[dict, dict, int]:
    """The port's graft into a numpy-seeded encoder, and the JAX graft into
    the same weights converted to Flax, converted back by name."""
    encoder = enc_helpers.randomize(PtEncoder(pcfg), seed)
    before = {k: v.clone() for k, v in encoder.state_dict().items()}
    variables = {"params": torch_import.convert_encoder(before, jcfg)}
    n = pt_pretrained.init_backbone_from_pretrained(encoder, pcfg)
    grafted, n_jax = jx_pretrained.init_backbone_from_pretrained(variables, jcfg)
    assert n_jax > 0
    want = from_jax.state_dict_from_jax(jax.device_get(grafted["params"]), pcfg)
    return before, {"port": encoder.state_dict(), "jax": want}, n


def check_graft(before, after, n, vit, trunk):
    trunks = {"backbone.dino.": vit.state_dict(), "backbone.resnet_backbone.model.": trunk.state_dict()}
    copied = 0
    for name, value in after["port"].items():
        assert torch.equal(value, after["jax"][name]), name
        prefix = next((p for p in trunks if name.startswith(p)), None)
        if prefix is None:  # heads, projections, token MLPs: their own weights
            assert torch.equal(value, before[name]), name
        else:
            assert torch.equal(value, trunks[prefix][name[len(prefix):]]), name
            copied += 1
    assert copied == n
    return copied


def test_graft_copies_every_trunk_tensor_as_jax_does(tiny_hub):
    _, jcfg, pcfg, vit, trunk = tiny_hub
    before, after, n = graft_against_jax(jcfg, pcfg, seed=8)
    n_vit = len(vit.state_dict())
    n_trunk = sum(1 for k in trunk.state_dict() if not k.startswith("layer4.") and "num_batches" not in k)
    assert check_graft(before, after, n, vit, trunk) == n_vit + n_trunk
    assert any(k.startswith("backbone.resnet_backbone.projections.") for k in before)


def test_graft_refuses_missing_keys_and_wrong_shapes(tiny_hub):
    directory, _, pcfg, vit, trunk = tiny_hub
    encoder = PtEncoder(pcfg)
    hub = pt_pretrained.load_state_dict_npz(directory / "tiny.npz")
    snapshot = {k: v.clone() for k, v in encoder.state_dict().items()}
    pt_pretrained.save_state_dict_npz({k: v for k, v in hub.items() if k != "blocks.1.mlp.fc2.bias"}, directory / "tiny.npz")
    with pytest.raises(KeyError, match="blocks.1.mlp.fc2.bias"):
        pt_pretrained.init_backbone_from_pretrained(encoder, pcfg)
    pt_pretrained.save_state_dict_npz(dict(hub, cls_token=np.zeros((1, 2, 64), np.float32)), directory / "tiny.npz")
    with pytest.raises(ValueError, match="shape mismatch at backbone.dino.cls_token"):
        pt_pretrained.init_backbone_from_pretrained(encoder, pcfg)
    # Nothing was copied by the refused grafts.
    assert all(torch.equal(v, snapshot[k]) for k, v in encoder.state_dict().items())
    # No ViT file: nothing at all, as the JAX package.
    (directory / "tiny.npz").unlink()
    assert pt_pretrained.init_backbone_from_pretrained(encoder, pcfg) == 0
    assert pt_pretrained.pretrained_trunks(encoder.backbone) == {}


def test_init_state_grafts_the_trunks(tiny_hub, capsys):
    directory, _, pcfg, vit, trunk = tiny_hub
    _, decoder = pt_config.re10k_ablation_no_epipolar_transformer()
    wrapper = ModelWrapper(pcfg, decoder, device="cpu")
    state = wrapper.init_state()
    assert "initialized" in capsys.readouterr().out
    for prefix, hub in (("dino", vit), ("resnet_backbone.model", trunk)):
        for name, value in hub.state_dict().items():
            if f"backbone.{prefix}.{name}" in state.params:
                assert torch.equal(state.params[f"backbone.{prefix}.{name}"].detach(), value), name
    for path in directory.glob("*.npz"):
        path.unlink()
    ModelWrapper(pcfg, decoder, device="cpu").init_state()
    assert "no pretrained DINO weights" in capsys.readouterr().out


def test_graft_matches_jax_at_full_vit_b_width(tmp_path, monkeypatch):
    """The JAX package's own case (`tests/test_pretrained_init.py`): hub
    ViT-B/16 and ResNet-50 modules from `tests/torch_shims.py`, exported to
    npz, grafted by both packages into the same weights. (~8 s: the JAX
    side converts the port's weights rather than initializing its own.)"""
    import torch_shims

    monkeypatch.setattr(torch_shims, "DINO_POS_GRID", 2)
    monkeypatch.setattr(pt_pretrained, "WEIGHTS_DIR", tmp_path)
    monkeypatch.setattr(jx_pretrained, "WEIGHTS_DIR", tmp_path)
    torch.manual_seed(0)
    vit = torch_shims._fake_hub_load("facebookresearch/dino:main", "dino_vitb16")
    resnet = torch_shims._fake_hub_load("facebookresearch/dino:main", "dino_resnet50")
    write_hub_weights(tmp_path, "dino_vitb16", vit, resnet)
    jcfg, pcfg = enc_helpers.tiny_encoder_cfgs()
    jcfg = dataclasses.replace(jcfg, backbone=dataclasses.replace(jcfg.backbone, model="dino_vitb16", pos_grid=2))
    pcfg = dataclasses.replace(pcfg, backbone=dataclasses.replace(pcfg.backbone, model="dino_vitb16", pos_grid=2))
    before, after, n = graft_against_jax(jcfg, pcfg, seed=9)
    hub_trunk = {k: v for k, v in resnet.state_dict().items()}
    check_graft(before, after, n, vit, SimpleModule(hub_trunk))
    assert n > 100


class SimpleModule:
    """A state_dict holder for `check_graft`."""

    def __init__(self, sd):
        self.sd = sd

    def state_dict(self):
        return self.sd
