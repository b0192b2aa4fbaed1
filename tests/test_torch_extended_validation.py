"""`Trainer.validation_step` with `train.extended_visualization` on the CPU:
the production `re10k` model at the small size of `test_torch_fit.py`
(64x64, slim backbones, a one-layer epipolar transformer) on the repo's
fixture made into a train split, numpy-seeded weights.

Every artifact of the JAX package's extended validation is logged: the
Gaussian projections, the camera diagram, the encoder's figures and the
wobble (60 frames) and interpolation (30 frames) videos, with no failure
caught and no pair dropped. A short wobble's frames match the JAX
decoder's on the same Gaussians within the render tolerance of
`test_torch_re10k.py`, and the encoder's capture leaves the plain encode's
outputs bit for bit unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from pixelsplat_tpu.model.decoder import get_decoder
from pixelsplat_tpu.model.types import Gaussians as JxGaussians
from pixelsplat_tpu.ops.rasterizer.projection import pack_gaussians_soa as jx_pack
from pixelsplat_tpu_torch import config as pt_config
from pixelsplat_tpu_torch import main as pt_main
from pixelsplat_tpu_torch.model.encoder.visualization.encoder_visualizer_epipolar import FIGURES
from pixelsplat_tpu_torch.ops.rasterizer.projection import pack_gaussians_soa as pt_pack
from pixelsplat_tpu_torch.training.model_wrapper import batch_to
from pixelsplat_tpu_torch.training.trainer import _strip_non_arrays, render_frames
from pixelsplat_tpu_torch.visualization.camera_trajectory.wobble import generate_wobble
from pixelsplat_tpu_torch.visualization.validation_in_3d import PROJECTION_SETTINGS

import test_torch_encoder as enc_helpers
import test_torch_re10k as re10k_helpers
import test_torch_slice as slice_helpers
from test_torch_fit import H, W, train_argv

STEP = 6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The port's trainer from `main.build_everything` with the option on,
    seeded weights, one validation batch and one `validation_step`."""
    from pixelsplat_tpu_torch.scripts.train_fixture import write_train_root

    tmp = tmp_path_factory.mktemp("extended")
    root = write_train_root(tmp / "re10k")
    with pytest.MonkeyPatch.context() as mp:
        re10k_helpers.shrink_backbones(mp)
        mp.setattr("pixelsplat_tpu_torch.utils.video.shutil.which", lambda name: None)  # GIFs, as here
        cfg = pt_config.load_config(train_argv(root, tmp / "out", "loss=[mse]", "train.extended_visualization=true"))
        assert cfg.train.extended_visualization
        trainer = pt_main.build_everything(cfg, "cpu")
        enc_helpers.randomize(trainer.wrapper.encoder, seed=66)
        batch = next(iter(trainer.data_module.val_dataloader()))
        metrics = trainer.validation_step(trainer.wrapper.init_state(), batch, STEP)
        yield dict(trainer=trainer, batch=batch, metrics=metrics, out=tmp / "out" / "local", cfg=cfg)


def gif_frames(path) -> list[np.ndarray]:
    with Image.open(path) as gif:
        frames = []
        for i in range(gif.n_frames):
            gif.seek(i)
            frames.append(np.asarray(gif.convert("RGB")))
    return frames


def test_every_artifact_is_logged(run):
    trainer, out = run["trainer"], run["out"]
    assert trainer.visualization_failures == []
    [record] = trainer.visualization_log
    assert record["step"] == STEP
    png = f"{STEP:0>6}.png"
    # The comparison grid as before, then the extended figures.
    for key in ["comparison", "projections", "cameras", *(f"encoder/{name}" for name in FIGURES)]:
        assert (out / key / png).is_file(), key
    assert record["encoder_figures"] == sorted(FIGURES) and record["encoder_omitted"] == {}
    # Three 256x256 projections side by side, bordered; the XY camera view.
    assert Image.open(out / "projections" / png).size == (3 * 256 + 2 * 8 + 2 * 8, 256 + 2 * 8)
    assert Image.open(out / "cameras" / png).size == (256, 256)
    # No pair dropped: each view at the JAX package's fixed settings or at
    # lists grown from them where they are too small for the scene.
    assert record["projection_overflow"] == [0, 0, 0]
    for settings in record["projection_settings"]:
        assert settings.capacity >= PROJECTION_SETTINGS.capacity
        assert settings.big_capacity >= PROJECTION_SETTINGS.big_capacity
    for name, frames in (("wobble", 60), ("interpolation", 30)):
        path = record[f"{name}_file"]
        assert path == out / "video" / name / f"{STEP:0>6}.gif" and path.is_file()
        decoded = gif_frames(path)
        assert len(decoded) == frames and decoded[0].shape == (H, W, 3)
        assert record[f"{name}_overflow"] == [0] * frames
    assert {f"val/psnr_{v}" for v in ("probabilistic", "deterministic")} <= run["metrics"].keys()


def test_a_failing_figure_is_counted_and_the_others_drawn(run, monkeypatch, capsys):
    """The camera diagram raises; the figures before and after it are
    still drawn (stand-ins here), and the failure is counted and printed."""
    from pixelsplat_tpu_torch.visualization import validation_in_3d

    trainer = run["trainer"]
    drawn = []

    def broken(*args, **kwargs):
        raise RuntimeError("no camera today")

    def projections(gaussians, resolution):
        drawn.append("projections")
        return validation_in_3d.Projections(torch.zeros((1, 3, 3, 8, 8)), torch.zeros((1, 3), dtype=torch.int32),
                                            (PROJECTION_SETTINGS,) * 3)

    monkeypatch.setattr(validation_in_3d, "render_projections", projections)
    monkeypatch.setattr(validation_in_3d, "render_cameras", broken)
    monkeypatch.setattr(
        "pixelsplat_tpu_torch.model.encoder.visualization.encoder_visualizer_epipolar.EncoderVisualizerEpipolar"
        ".visualize", lambda self, *args, **kwargs: drawn.append("encoder") or {"depth": np.zeros((3, 4, 4))},
    )
    monkeypatch.setattr(trainer, "render_video_wobble", lambda *args: drawn.append("wobble") or (None, []))
    monkeypatch.setattr(trainer, "render_video_interpolation", lambda *args: drawn.append("interp") or (None, []))
    before = len(trainer.visualization_failures)
    record = trainer.extended_visualization({"context": None}, None, STEP + 1)
    assert trainer.visualization_failures[before:] == ["cameras: RuntimeError: no camera today"]
    assert "extended visualization cameras failed: RuntimeError: no camera today" in capsys.readouterr().out
    assert drawn == ["projections", "encoder", "wobble", "interp"] and record["encoder_figures"] == ["depth"]
    assert (run["out"] / "encoder" / "depth" / f"{STEP + 1:0>6}.png").is_file()
    del trainer.visualization_failures[before:]
    trainer.visualization_log.pop()


def test_wobble_frames_match_the_jax_decoder(run):
    """Three wobble frames through the port's decoder, one at a time, and
    through the JAX decoder on the same Gaussians in one call."""
    trainer, batch, cfg = run["trainer"], run["batch"], run["cfg"]
    extr = np.asarray(batch["context"]["extrinsics"][0])
    intr = np.asarray(batch["context"]["intrinsics"][0])
    delta = float(np.linalg.norm(extr[0, :3, 3] - extr[-1, :3, 3]))
    cameras = generate_wobble(extr[0], np.asarray(delta * 0.25), np.linspace(0, 1, 3).astype(np.float32))
    intrinsics = np.broadcast_to(intr[0], (3, 3, 3))
    arrays = batch_to(_strip_non_arrays(batch), trainer.wrapper.device)
    g = trainer.wrapper.make_eval_encode()(arrays, True, STEP)
    got, overflow = render_frames(
        trainer.wrapper.decoder, g, torch.as_tensor(cameras), torch.as_tensor(np.ascontiguousarray(intrinsics)),
        arrays["context"]["near"][0, 0], arrays["context"]["far"][0, 0], (H, W),
    )
    assert got.shape == (3, 3, H, W) and overflow == [0, 0, 0]

    near = np.full((1, 3), float(batch["context"]["near"][0, 0]), np.float32)
    far = np.full((1, 3), float(batch["context"]["far"][0, 0]), np.float32)
    from pixelsplat_tpu.config import load_config

    decoder = get_decoder(load_config(["+experiment=re10k"]).model.decoder)
    assert decoder.cfg.render.capacity == cfg.model.decoder.render.capacity
    gaussians = JxGaussians(*(jnp.asarray(x.numpy()) for x in g))
    out = jax.jit(decoder, static_argnums=(5,))(
        gaussians, jnp.asarray(cameras)[None], jnp.asarray(intrinsics)[None], jnp.asarray(near), jnp.asarray(far),
        (H, W),
    )
    want = np.asarray(out.color)
    assert int(out.overflow) == 0
    # The tiles whose lists differ only by depth-key ties, as test_torch_re10k.py excuses them.
    soa_j = jx_pack(*(jnp.asarray(x.numpy()[0]) for x in (g.means, g.covariances, g.opacities)),
                    harmonics=jnp.asarray(g.harmonics.numpy()[0]))
    soa_p = pt_pack(g.means[0], g.covariances[0], g.opacities[0], harmonics=g.harmonics[0])
    target = {"extrinsics": cameras[None], "intrinsics": np.ascontiguousarray(intrinsics)[None], "near": near}
    excused = slice_helpers.tie_reordered_tiles(
        soa_j, soa_p, {"target": target}, {"target": {k: torch.as_tensor(v) for k, v in target.items()}},
        cfg.model.decoder.render,
    )
    re10k_helpers.assert_images_close(got.numpy()[None], want, excused)


def test_capture_leaves_the_encode_unchanged(run):
    """The same encode with and without the capture (and its dump), on the
    same uniforms: the same bits."""
    trainer, batch = run["trainer"], run["batch"]
    encoder = trainer.wrapper.encoder
    context = batch_to(_strip_non_arrays(batch), trainer.wrapper.device)["context"]
    u = torch.rand((1, 2, H * W, 1, 3), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        plain = encoder(context, STEP, False, u=u)
        dump = {}
        with encoder.capture_intermediates() as captured:
            captured_run = encoder(context, STEP, False, u=u, visualization_dump=dump)
    for name in plain._fields:
        assert torch.equal(getattr(plain, name), getattr(captured_run, name)), name
    assert len(captured["attention"]) == encoder.cfg.epipolar_transformer.num_layers
    assert captured["pdf"].shape == (1, 2, H * W, 1, encoder.cfg.num_monocular_samples)
