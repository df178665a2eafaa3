"""Convert a port pretraining checkpoint for transfer evaluation (the
counterpart of the root convert_pretrain.py and moco_tpu/export.py:47-146).

    python -m moco_tpu_torch.convert_pretrain WORKDIR out.pth   # ResNet: torchvision names
                                                                # ViT: timm names
    python -m moco_tpu_torch.convert_pretrain WORKDIR out.pkl   # detectron2 pickle (ResNet)

The query encoder's backbone of the newest good checkpoint under WORKDIR,
without the projection head; the architecture comes from the checkpoint's
config. A ResNet's `.pth` holds the backbone's tensors under torchvision
names, BN `num_batches_tracked` included, so it loads with strict=True
into the port's backbone (and with strict=False, as `main_lincls.py`
loads, into a torchvision ResNet). A ViT's `.pth` holds timm
`vision_transformer` names (`convert.vit_to_timm`, as the root
convert_pretrain.py writes them). The detectron2 pickle is the reference
converter's envelope (`detection/convert-pretrain-to-detectron2.py`):
detectron2's ResNet names, numpy values, `{"model", "__author__": "MOCO",
"matching_heuristics": True}`; a ViT is refused there.
"""

from __future__ import annotations

import argparse
import pickle
import sys
from typing import Dict

import numpy as np
import torch

from moco_tpu_torch.convert import vit_to_timm
from moco_tpu_torch.lincls import load_pretrained_backbone

D2_VIT_REFUSAL = ("detectron2 export is the R50-C4 detection recipe (ResNet only); "
                  "ViT checkpoints export as a timm state dict (.pth)")


def pretrained_backbone_state(workdir: str) -> tuple[Dict[str, torch.Tensor], str]:
    """(the query encoder's backbone tensors, arch) from the newest good
    checkpoint under `workdir`, the probe's surgery on the CPU: a ResNet's
    under torchvision names, a ViT's under timm names."""
    backbone, _, config = load_pretrained_backbone(workdir, device="cpu")
    sd = {k: v.contiguous() for k, v in backbone.state_dict().items()}
    if config.moco.arch.startswith("vit"):
        timm = vit_to_timm(sd, patch_size=backbone.patch_size,
                           image_size=config.data.image_size)
        sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in timm.items()}
    return sd, config.moco.arch


def torchvision_to_detectron2(state: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The reference converter's renaming (`~L10-30`): a `stem.` prefix for
    keys outside the stages, layer{t} -> res{t+1}, bn{t} -> conv{t}.norm,
    downsample.0 -> shortcut, downsample.1 -> shortcut.norm."""
    out = {}
    for k, v in state.items():
        if "layer" not in k:
            k = "stem." + k
        for t in (1, 2, 3, 4):
            k = k.replace(f"layer{t}", f"res{t + 1}")
        for t in (1, 2, 3):
            k = k.replace(f"bn{t}", f"conv{t}.norm")
        k = k.replace("downsample.0", "shortcut")
        k = k.replace("downsample.1", "shortcut.norm")
        out[k] = v
    return out


def save_detectron2_pickle(state: Dict[str, torch.Tensor], path: str) -> None:
    """The reference's envelope of the renamed float tensors (the BN
    counters, which detectron2 does not keep, are left out)."""
    arrays = {k: v.detach().cpu().float().numpy() for k, v in state.items()
              if not k.endswith("num_batches_tracked")}
    blob = {"model": torchvision_to_detectron2(arrays), "__author__": "MOCO",
            "matching_heuristics": True}
    with open(path, "wb") as f:
        pickle.dump(blob, f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("workdir", help="pretraining workdir (the port's checkpoints)")
    ap.add_argument("output", help="output .pth (torch state_dict) or .pkl (detectron2)")
    ap.add_argument("--format", choices=("d2", "torch"), default=None,
                    help="default: from the output's extension")
    args = ap.parse_args(argv)
    state, arch = pretrained_backbone_state(args.workdir)
    fmt = args.format or ("torch" if args.output.endswith(".pth") else "d2")
    if fmt == "d2" and arch.startswith("vit"):
        raise SystemExit(D2_VIT_REFUSAL)
    if fmt == "d2":
        save_detectron2_pickle(state, args.output)
    else:
        torch.save(state, args.output)
    print(f"wrote {len(state)} tensors of {arch} -> {args.output} ({fmt})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
