"""Write the pretrained weights the port reads: `lpips_vgg.npz` and `dino_*.npz`.

From the published files on disk:

    python -m pixelsplat_tpu_torch.scripts.export_weights \\
        --lpips-lin vgg.pth --vgg16 vgg16-397923af.pth \\
        --dino-vit dino_vitb8=dino_vitbase8_pretrain.pth \\
        --dino-resnet50 dino_resnet50_pretrain.pth [--out weights]

`--lpips-lin` is the `lpips` package's `weights/v0.1/vgg.pth`, `--vgg16`
torchvision's VGG16 state_dict; `--lpips-state-dict` takes one full
`lpips.LPIPS(net="vgg").state_dict()` saved with `torch.save` in their
place. `--dino-vit NAME=PATH` (repeatable) and `--dino-resnet50 PATH` take
the checkpoints that `torch.hub.load("facebookresearch/dino:main", NAME)`
downloads. Each npz has the keys and layout that the JAX package's
`tools/export_lpips_weights.py` and `tools/export_dino_weights.py` write,
so both packages read the same files. The LPIPS files and the DINO files
are written independently: give either set, or both.

Given no path at all, the script takes the JAX tools' download route: the
`lpips` package for LPIPS and `torch.hub` for `dino_vitb8` and
`dino_resnet50` (or the ViTs named by `--dino-vit NAME`). That needs the
network.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..evaluation.lpips import LPIPS, load_lpips_published, lpips_npz_arrays
from ..interop.pretrained import WEIGHTS_DIR, export_hub_state_dict, save_state_dict_npz


def write_lpips_npz(model: LPIPS, out_dir: Path) -> Path:
    path = Path(out_dir) / "lpips_vgg.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **lpips_npz_arrays(model))
    return path


def download_lpips() -> LPIPS:
    """The `lpips` package's LPIPS(net="vgg") weights (it downloads VGG16)."""
    try:
        import lpips  # type: ignore
    except ImportError as exc:
        raise SystemExit(
            "the lpips package is not installed: give --lpips-lin and --vgg16 (or --lpips-state-dict) "
            "with the published files instead"
        ) from exc
    return load_lpips_published(state_dict=lpips.LPIPS(net="vgg").state_dict())


def download_dino(name: str, out_dir: Path) -> Path:
    import torch

    module = torch.hub.load("facebookresearch/dino:main", name)
    path = Path(out_dir) / f"{name}.npz"
    save_state_dict_npz(module.state_dict(), path)
    return path


def parse_args(argv):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--lpips-lin", type=Path, help="the lpips package's weights/v0.1/vgg.pth")
    parser.add_argument("--vgg16", type=Path, help="torchvision's VGG16 state_dict")
    parser.add_argument("--lpips-state-dict", type=Path, help='a saved lpips.LPIPS(net="vgg").state_dict()')
    parser.add_argument("--dino-vit", action="append", default=[], metavar="NAME[=PATH]",
                        help="a DINO ViT by hub name, with its published checkpoint")
    parser.add_argument("--dino-resnet50", type=Path, help="dino_resnet50_pretrain.pth")
    parser.add_argument("--out", type=Path, default=WEIGHTS_DIR)
    args = parser.parse_args(argv)
    if (args.lpips_lin is None) != (args.vgg16 is None):
        parser.error("--lpips-lin and --vgg16 go together")
    if args.lpips_state_dict is not None and args.lpips_lin is not None:
        parser.error("give --lpips-lin with --vgg16, or --lpips-state-dict, not both")
    return args


def main(argv=None) -> list[Path]:
    args = parse_args(argv)
    vits = dict(item.split("=", 1) if "=" in item else (item, None) for item in args.dino_vit)
    from_files = args.lpips_lin or args.lpips_state_dict or args.dino_resnet50 or any(vits.values())
    written = []
    if from_files:
        if args.lpips_lin is not None or args.lpips_state_dict is not None:
            model = load_lpips_published(args.lpips_lin, args.vgg16, args.lpips_state_dict)
            written.append(write_lpips_npz(model, args.out))
        for name, src in vits.items():
            if src is None:
                raise SystemExit(f"--dino-vit {name}: give its checkpoint as {name}=PATH")
            written.append(export_hub_state_dict(Path(src), name, args.out))
        if args.dino_resnet50 is not None:
            written.append(export_hub_state_dict(args.dino_resnet50, "dino_resnet50", args.out))
    else:
        written.append(write_lpips_npz(download_lpips(), args.out))
        for name in [*(vits or ["dino_vitb8"]), "dino_resnet50"]:
            written.append(download_dino(name, args.out))
    for path in written:
        print(f"wrote {path}")
    return written


if __name__ == "__main__":
    main()
