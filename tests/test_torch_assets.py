"""The port's own weight import and fixture generator against the JAX
package's, on the CPU.

No published weights are in the repository, so every test writes seeded
random weights in the published files' layouts: the `lpips` package's lin
file (`weights/v0.1/vgg.pth`), torchvision's VGG16 state_dict, one full
`lpips.LPIPS(net="vgg").state_dict()`, and DINO hub checkpoints (a narrow
ViT and a slim ResNet trunk built from the port's own modules, under the
hub's parameter names).
"""

import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelsplat_tpu.evaluation import lpips as jx_lpips
from pixelsplat_tpu.interop import pretrained as jx_pretrained
from pixelsplat_tpu.interop.torch_import import convert_lpips
from pixelsplat_tpu_torch.evaluation import lpips as pt_lpips
from pixelsplat_tpu_torch.interop import pretrained as pt_pretrained
from pixelsplat_tpu_torch.model.encoder.backbone import dino as pt_dino
from pixelsplat_tpu_torch.model.encoder.backbone import resnet as pt_resnet
from pixelsplat_tpu_torch.model.encoder.encoder_epipolar import EncoderEpipolar as PtEncoder
from pixelsplat_tpu_torch.scripts import export_weights, make_fixture_chunk

import test_torch_encoder as enc_helpers
import test_torch_re10k as re10k_helpers

ROOT = Path(__file__).resolve().parent.parent
# The LPIPS sum over five stages of 13 f32 convolutions, in another order.
LPIPS_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: next to the other test processes, more threads
    only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# LPIPS


def published_lpips_state_dict(seed: int) -> dict[str, torch.Tensor]:
    """A full `lpips.LPIPS(net="vgg").state_dict()` with seeded random
    weights, in the package's key order: the scaling layer's buffers, the
    VGG slices, the lin layers under their attribute names and again under
    `lins`."""
    rng = np.random.default_rng(seed)
    sd = {
        "scaling_layer.shift": torch.tensor(pt_lpips.SHIFT)[None, :, None, None],
        "scaling_layer.scale": torch.tensor(pt_lpips.SCALE)[None, :, None, None],
    }
    in_ch = 3
    for i, (ch, _) in enumerate(pt_lpips.VGG16_PLAN):
        key = f"net.slice{pt_lpips.SLICE_OF[i]}.{pt_lpips.TV_INDICES[i]}"
        sd[f"{key}.weight"] = torch.from_numpy((rng.normal(size=(ch, in_ch, 3, 3)) / np.sqrt(9 * in_ch)).astype(np.float32))
        sd[f"{key}.bias"] = torch.from_numpy((0.1 * rng.normal(size=ch)).astype(np.float32))
        in_ch = ch
    lins = [torch.from_numpy(rng.uniform(0, 0.1, (1, pt_lpips.VGG16_PLAN[t][0], 1, 1)).astype(np.float32))
            for t in pt_lpips.TAPS]
    for prefix in ("lin{}", "lins.{}"):
        for i, w in enumerate(lins):
            sd[f"{prefix.format(i)}.model.1.weight"] = w
    return sd


def save_published_files(sd: dict, directory: Path) -> dict[str, Path]:
    """The lin file, a torchvision-layout VGG16 file (its `features`, and
    the last classifier layer: the full classifier is 0.5 GB) and the full
    state_dict, each saved with `torch.save`."""
    rng = np.random.default_rng(1)
    vgg = {}
    for i, tv in enumerate(pt_lpips.TV_INDICES):
        for p in ("weight", "bias"):
            vgg[f"features.{tv}.{p}"] = sd[f"net.slice{pt_lpips.SLICE_OF[i]}.{tv}.{p}"].clone()
    vgg["classifier.6.weight"] = torch.from_numpy(rng.normal(size=(1000, 4096)).astype(np.float32))
    vgg["classifier.6.bias"] = torch.zeros(1000)
    files = {"lin": directory / "vgg.pth", "vgg": directory / "vgg16-397923af.pth", "full": directory / "lpips.pth"}
    torch.save({f"lin{i}.model.1.weight": sd[f"lin{i}.model.1.weight"].clone() for i in range(5)}, files["lin"])
    torch.save(vgg, files["vgg"])
    torch.save(sd, files["full"])
    return files


@pytest.fixture(scope="module")
def published(tmp_path_factory):
    sd = published_lpips_state_dict(seed=4)
    return sd, save_published_files(sd, tmp_path_factory.mktemp("published"))


def test_lpips_read_directly_matches_jax(published):
    sd, files = published
    direct = pt_lpips.load_lpips_published(files["lin"], files["vgg"])
    full = pt_lpips.load_lpips_published(state_dict=files["full"])
    assert direct.state_dict().keys() == full.state_dict().keys()
    for k, v in direct.state_dict().items():
        assert torch.equal(v, full.state_dict()[k]), k
        assert torch.equal(v, sd[k]), k  # the renaming keeps every bit
    assert all(not p.requires_grad for p in direct.parameters())

    params = convert_lpips({k: v.numpy() for k, v in sd.items()})
    rng = np.random.default_rng(5)
    a = rng.uniform(0, 1, (3, 3, 64, 64)).astype(np.float32)
    b = np.clip(a + 0.2 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    want = np.asarray(jx_lpips.compute_lpips(jnp.asarray(a), jnp.asarray(b), params=params))
    with torch.no_grad():
        got = direct(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert (want > 0).all()
    np.testing.assert_allclose(got, want, rtol=LPIPS_RTOL, atol=0)


def test_lpips_published_files_are_checked(published, tmp_path):
    sd, files = published
    with pytest.raises(ValueError, match="lin_path and vgg_path"):
        pt_lpips.load_lpips_published(files["lin"])
    with pytest.raises(ValueError, match="lin_path and vgg_path"):
        pt_lpips.load_lpips_published(files["lin"], files["vgg"], state_dict=files["full"])
    bad = dict(sd)
    bad["scaling_layer.scale"] = bad["scaling_layer.scale"] * 2
    with pytest.raises(ValueError, match="scaling_layer.scale"):
        pt_lpips.load_lpips_published(state_dict=bad)
    bad = dict(sd)
    bad["lin2.model.1.weight"] = bad["lin2.model.1.weight"] + 1
    with pytest.raises(ValueError, match="lin2"):
        pt_lpips.load_lpips_published(state_dict=bad)
    with pytest.raises(KeyError, match="unexpected"):
        pt_lpips.load_lpips_published(state_dict={**sd, "head.weight": torch.zeros(1)})
    with pytest.raises(RuntimeError, match="net.slice6.0.weight"):  # the strict load
        pt_lpips.load_lpips_published(state_dict={**sd, "net.slice6.0.weight": torch.zeros(1)})
    torch.save({"features.0.weight": torch.zeros(64, 3, 3, 3)}, tmp_path / "short.pth")
    with pytest.raises(KeyError, match="missing"):
        pt_lpips.load_lpips_published(files["lin"], tmp_path / "short.pth")


def jax_tool_arrays(sd: dict) -> dict[str, np.ndarray]:
    """What the JAX package's tools/export_lpips_weights.py saves, from its
    conversion step (the tool itself imports `lpips`)."""
    params = convert_lpips({k: v.numpy() for k, v in sd.items()})["params"]
    out = {}
    for i, conv in params["vgg"].items():
        out[f"vgg_{i}_kernel"] = conv["kernel"]
        out[f"vgg_{i}_bias"] = conv["bias"]
    for key, value in params.items():
        if key.startswith("lin"):
            out[f"{key}_kernel"] = value["kernel"]
    return out


@pytest.mark.parametrize("route", ["lin_and_vgg16", "state_dict"])
def test_export_weights_lpips_npz_is_the_jax_tools(published, tmp_path, route):
    sd, files = published
    args = ["--lpips-lin", str(files["lin"]), "--vgg16", str(files["vgg"])]
    if route == "state_dict":
        args = ["--lpips-state-dict", str(files["full"])]
    (path,) = export_weights.main(args + ["--out", str(tmp_path / "weights")])
    assert path == tmp_path / "weights" / "lpips_vgg.npz"
    want = jax_tool_arrays(sd)
    np.savez(tmp_path / "jax_tool.npz", **want)
    assert path.read_bytes() == (tmp_path / "jax_tool.npz").read_bytes()
    with np.load(path) as z:
        assert list(z.files) == list(want)
        for k, v in want.items():
            assert z[k].dtype == v.dtype and np.array_equal(z[k], v), k
    # Both packages read it back to the same weights.
    loaded = pt_lpips.load_lpips(str(path))
    for k, v in pt_lpips.load_lpips_published(files["lin"], files["vgg"]).state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    jx_params = jx_lpips.load_lpips_params.__wrapped__(str(path))["params"]
    for i in range(13):
        np.testing.assert_array_equal(np.asarray(jx_params["vgg"][f"conv{i}"]["kernel"]), want[f"vgg_conv{i}_kernel"])


def test_export_weights_arguments():
    with pytest.raises(SystemExit):
        export_weights.parse_args(["--lpips-lin", "vgg.pth"])
    with pytest.raises(SystemExit):
        export_weights.parse_args(["--lpips-lin", "a", "--vgg16", "b", "--lpips-state-dict", "c"])
    with pytest.raises(SystemExit, match="dino_vitb8=PATH"):
        export_weights.main(["--dino-vit", "dino_vitb8", "--dino-resnet50", "r.pth"])
    args = export_weights.parse_args([])
    assert args.out == pt_pretrained.WEIGHTS_DIR == ROOT / "weights"


# ---------------------------------------------------------------------------
# DINO


def hub_checkpoints(seed: int) -> tuple[dict, dict]:
    """A hub-named ViT (the tiny spec) and a `dino_resnet50` checkpoint as
    published: torchvision's full four-stage trunk (here with the slim
    stage sizes) with its BatchNorm counters and the `fc` head."""
    vit_spec = pt_dino.VIT_SPECS["tiny"]
    vit = pt_dino.DinoViT(vit_spec["patch"], vit_spec["dim"], vit_spec["depth"], vit_spec["heads"], 224 // vit_spec["patch"])
    trunk = pt_resnet.BackboneResnet(pt_resnet.BackboneResnetCfg(model="dino_resnet50", num_layers=5)).model
    enc_helpers.randomize(vit, seed)
    enc_helpers.randomize(trunk, seed + 1)
    resnet = {}
    for k, v in trunk.state_dict().items():
        resnet[k] = v.detach().clone()
        if k.endswith("running_var"):
            resnet[k.replace("running_var", "num_batches_tracked")] = torch.tensor(seed, dtype=torch.int64)
    resnet["fc.weight"], resnet["fc.bias"] = torch.zeros(1000, 2048), torch.zeros(1000)
    return {k: v.detach().clone() for k, v in vit.state_dict().items()}, resnet


def test_dino_hub_checkpoints_export_and_graft(tmp_path, monkeypatch):
    re10k_helpers.shrink_backbones(monkeypatch)
    vit, resnet = hub_checkpoints(seed=7)
    torch.save(vit, tmp_path / "tiny.pth")
    torch.save(resnet, tmp_path / "dino_resnet50_pretrain.pth")
    out = tmp_path / "weights"
    written = export_weights.main(["--dino-vit", f"tiny={tmp_path / 'tiny.pth'}", "--dino-resnet50",
                                   str(tmp_path / "dino_resnet50_pretrain.pth"), "--out", str(out)])
    assert written == [out / "tiny.npz", out / "dino_resnet50.npz"]
    for path, source in zip(written, (vit, {k: v for k, v in resnet.items() if not k.startswith("fc.")})):
        exported = pt_pretrained.load_state_dict_npz(path)
        assert list(exported) == list(source)
        for k, v in source.items():
            assert exported[k].dtype == v.numpy().dtype and np.array_equal(exported[k], v.numpy()), k
        # The JAX package's reader sees the same arrays.
        assert {k: v.tobytes() for k, v in jx_pretrained.load_state_dict_npz(path).items()} == {
            k: v.tobytes() for k, v in exported.items()
        }

    monkeypatch.setattr(pt_pretrained, "WEIGHTS_DIR", out)
    _, cfg = enc_helpers.tiny_encoder_cfgs()
    encoder = PtEncoder(cfg)
    trunks = {"backbone.dino": vit}
    trunks["backbone.resnet_backbone.model"] = {k: v for k, v in resnet.items()}
    want = {}
    for prefix, module in (("backbone.dino", encoder.backbone.dino),
                           ("backbone.resnet_backbone.model", encoder.backbone.resnet_backbone.model)):
        for name in module.state_dict():
            want[f"{prefix}.{name}"] = trunks[prefix][name]
    assert pt_pretrained.init_backbone_from_pretrained(encoder) == len(want)
    state = encoder.state_dict()
    for k, v in want.items():
        assert torch.equal(state[k], v), k


def test_dino_hub_checkpoint_is_read_as_the_hub_loads_it(monkeypatch):
    re10k_helpers.shrink_backbones(monkeypatch)
    vit, resnet = hub_checkpoints(seed=3)
    # The hub's ResNet loads non-strictly: a counter the file lacks keeps 0.
    del resnet["layer1.0.bn1.num_batches_tracked"]
    sd = pt_pretrained.hub_module_state_dict(resnet, "dino_resnet50")
    assert "fc.weight" not in sd and int(sd["layer1.0.bn1.num_batches_tracked"]) == 0
    assert int(sd["bn1.num_batches_tracked"]) == 3
    with pytest.raises(KeyError, match="layer4.0.conv1.weight"):
        pt_pretrained.hub_module_state_dict({k: v for k, v in resnet.items() if not k.startswith("layer4.0.conv1")},
                                            "dino_resnet50")
    with pytest.raises(KeyError, match="head.weight"):
        pt_pretrained.hub_module_state_dict({**vit, "head.weight": torch.zeros(3)}, "tiny")
    with pytest.raises(ValueError, match="pos_embed"):
        pt_pretrained.hub_module_state_dict({**vit, "pos_embed": torch.zeros(1, 5, 64)}, "tiny")


# ---------------------------------------------------------------------------
# The fixture


def load_jax_tool(monkeypatch, root: Path):
    spec = importlib.util.spec_from_file_location("jax_make_fixture_chunk", ROOT / "tools" / "make_fixture_chunk.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    monkeypatch.setattr(tool, "FIXTURE_ROOT", root)
    return tool


def test_fixture_generator_writes_the_jax_tools_bytes(tmp_path, monkeypatch):
    load_jax_tool(monkeypatch, tmp_path / "jax" / "re10k").main()
    path = make_fixture_chunk.main(["--out", str(tmp_path / "port" / "re10k")])
    assert path == tmp_path / "port" / "re10k" / "test" / "000000.torch"
    for name in ("re10k/test/000000.torch", "re10k/test/index.json", "evaluation_index_fixture.json"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name

    # Against the checked-in fixture: the same scenes and cameras bit for
    # bit, and frames within 2/255 in mean (the JPEG encoder's version may
    # differ from the one that wrote it).
    stats = make_fixture_chunk.compare_fixtures(tmp_path / "port" / "re10k", ROOT / "tests" / "fixtures" / "re10k")
    assert stats["same_metadata"] and stats["same_index"] and stats["frames"] == 16
    assert stats["max_mean_levels"] <= 2.0, stats
    assert json.loads((tmp_path / "port" / "evaluation_index_fixture.json").read_text()) == json.loads(
        (ROOT / "tests" / "fixtures" / "evaluation_index_fixture.json").read_text()
    )


def test_fixture_generator_never_writes_the_checked_in_fixture(tmp_path):
    before = {p: p.read_bytes() for p in (ROOT / "tests" / "fixtures").rglob("*") if p.is_file()}
    for out in ("re10k", "other", "."):
        with pytest.raises(ValueError, match="not rewritten"):
            make_fixture_chunk.make_fixture(ROOT / "tests" / "fixtures" / out)
    after = {p: p.read_bytes() for p in (ROOT / "tests" / "fixtures").rglob("*") if p.is_file()}
    assert before == after
    assert make_fixture_chunk.DEFAULT_OUT == ROOT / "build" / "fixtures" / "re10k"
