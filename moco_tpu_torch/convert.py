"""Weights across the two packages: Flax encoder trees -> the port's state_dict.

The layout rules are those of moco_tpu/export.py (resnet_to_torchvision)
and moco_tpu/import_torch.py (head_from_torch), kept here as a copy:

- conv kernels (H, W, Cin, Cout) -> (Cout, Cin, H, W)
- dense kernels (Cin, Cout) -> (Cout, Cin)
- BatchNorm: scale -> weight, bias -> bias, mean -> running_mean,
  var -> running_var

Flax trees come in as nested dicts of numpy arrays (or anything
`np.asarray` takes): `{"backbone": ..., "head": ...}` for the params and
`{"backbone": ...}` for the batch statistics. A tree shaped like the
params without statistics (optax's momentum trace) goes through the same
rules with `batch_stats=None`.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from moco_tpu_torch.core.moco import TrainState, build_encoder, create_state
from moco_tpu_torch.models.resnet import _CONFIGS
from moco_tpu_torch.utils.config import MocoConfig, TrainConfig


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _conv(kernel) -> np.ndarray:
    return _np(kernel).transpose(3, 2, 0, 1)


def _bn(out: dict, name: str, params, stats) -> None:
    out[f"{name}.weight"] = _np(params["scale"])
    out[f"{name}.bias"] = _np(params["bias"])
    if stats is not None:
        out[f"{name}.running_mean"] = _np(stats["mean"])
        out[f"{name}.running_var"] = _np(stats["var"])


def _sub(stats, name: str):
    return None if stats is None else stats[name]


def _convbn(out: dict, conv_name: str, bn_name: str, params, stats) -> None:
    out[f"{conv_name}.weight"] = _conv(params["Conv_0"]["kernel"])
    _bn(out, bn_name, params["BatchNorm_0"], _sub(stats, "BatchNorm_0"))


def backbone_from_flax(params: Any, stats: Any = None) -> Dict[str, np.ndarray]:
    """Flax ResNet tree -> torchvision-named arrays. The stage of each
    block is read off the tree: a stage is a run of blocks of one width.
    `stats=None` converts a params-shaped tree alone (no running_*)."""
    out: Dict[str, np.ndarray] = {}
    if "Conv_0" in params:  # ImageNet stem
        out["conv1.weight"] = _conv(params["Conv_0"]["kernel"])
        _bn(out, "bn1", params["BatchNorm_0"], _sub(stats, "BatchNorm_0"))
    else:  # CIFAR stem
        _convbn(out, "conv1", "bn1", params["ConvBN_0"], _sub(stats, "ConvBN_0"))
    names = sorted(
        (k for k in params if k.startswith(("Bottleneck_", "BasicBlock_"))),
        key=lambda k: int(k.rsplit("_", 1)[1]),
    )
    stage, j, width = 0, 0, None
    for name in names:
        bp, bs = params[name], _sub(stats, name)
        w = np.shape(bp["ConvBN_0"]["Conv_0"]["kernel"])[-1]
        if width is not None and w != width:
            stage, j = stage + 1, 0
        width = w
        n_main = 3 if name.startswith("Bottleneck_") else 2
        prefix = f"layer{stage + 1}.{j}"
        for c in range(n_main):
            _convbn(out, f"{prefix}.conv{c + 1}", f"{prefix}.bn{c + 1}",
                    bp[f"ConvBN_{c}"], _sub(bs, f"ConvBN_{c}"))
        if f"ConvBN_{n_main}" in bp:  # downsample branch
            _convbn(out, f"{prefix}.downsample.0", f"{prefix}.downsample.1",
                    bp[f"ConvBN_{n_main}"], _sub(bs, f"ConvBN_{n_main}"))
        j += 1
    return out


def head_from_flax(params: Any) -> Dict[str, np.ndarray]:
    """ProjectionHead tree -> `fc.*` (v1) or `fc.0.*` / `fc.2.*` (v2)."""
    if "Dense_1" in params:
        pairs = (("fc.0", params["Dense_0"]), ("fc.2", params["Dense_1"]))
    else:
        pairs = (("fc", params["Dense_0"]),)
    out = {}
    for name, dense in pairs:
        out[f"{name}.weight"] = _np(dense["kernel"]).T
        out[f"{name}.bias"] = _np(dense["bias"])
    return out


def encoder_from_flax(params: Any, batch_stats: Any = None) -> Dict[str, torch.Tensor]:
    """Flax `MoCoEncoder` variables -> the port's `MoCoEncoder` state_dict
    (`backbone.*` in torchvision names, `head.fc*`); parameters only when
    `batch_stats` is None."""
    stats = None if batch_stats is None else batch_stats["backbone"]
    sd = {f"backbone.{k}": v for k, v in backbone_from_flax(params["backbone"], stats).items()}
    sd.update({f"head.{k}": v for k, v in head_from_flax(params["head"]).items()})
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}


def random_flax_encoder(
    cfg: MocoConfig, seed: int = 0, num_filters: int = 64
) -> tuple[dict, dict]:
    """(params, batch_stats) of a Flax `MoCoEncoder` made with numpy from
    `seed`: He-normal (fan_out) convs as the Flax init, BN scale 1 and
    bias 0, running statistics drawn near (0, 1), LeCun-normal dense
    kernels. Random weights in the exact tree a trained checkpoint has, so
    they reach the port through `encoder_from_flax` like real ones."""
    rng = np.random.default_rng(seed)
    spec = _CONFIGS[cfg.arch]
    bottleneck = spec["block"].__name__ == "Bottleneck"
    expansion = 4 if bottleneck else 1

    def conv(k, cin, cout):
        return {"kernel": (rng.standard_normal((k, k, cin, cout)) * np.sqrt(2.0 / (k * k * cout))
                           ).astype(np.float32)}

    def bn(c):
        p = {"scale": np.ones(c, np.float32), "bias": np.zeros(c, np.float32)}
        s = {"mean": (0.1 * rng.standard_normal(c)).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
        return p, s

    def convbn(k, cin, cout):
        p, s = bn(cout)
        return {"Conv_0": conv(k, cin, cout), "BatchNorm_0": p}, {"BatchNorm_0": s}

    params, stats = {}, {}
    if cfg.cifar_stem:
        params["ConvBN_0"], stats["ConvBN_0"] = convbn(3, 3, num_filters)
    else:
        params["Conv_0"] = conv(7, 3, num_filters)
        params["BatchNorm_0"], stats["BatchNorm_0"] = bn(num_filters)
    cin, b = num_filters, 0
    for i, num_blocks in enumerate(spec["stage_sizes"]):
        f = num_filters * 2**i
        for j in range(num_blocks):
            stride = 2 if i > 0 and j == 0 else 1
            shapes = ((1, cin, f), (3, f, f), (1, f, f * 4)) if bottleneck else (
                (3, cin, f), (3, f, f))
            if stride != 1 or cin != f * expansion:
                shapes += ((1, cin, f * expansion),)
            bp, bs = {}, {}
            for c, shape in enumerate(shapes):
                bp[f"ConvBN_{c}"], bs[f"ConvBN_{c}"] = convbn(*shape)
            name = f"{spec['block'].__name__}_{b}"
            params[name], stats[name] = bp, bs
            cin, b = f * expansion, b + 1

    def dense(cin, cout):
        return {"kernel": (rng.standard_normal((cin, cout)) / np.sqrt(cin)).astype(np.float32),
                "bias": np.zeros(cout, np.float32)}

    head = ({"Dense_0": dense(cin, cin), "Dense_1": dense(cin, cfg.dim)} if cfg.mlp
            else {"Dense_0": dense(cin, cfg.dim)})
    return {"backbone": params, "head": head}, {"backbone": stats}


def state_from_flax(config: TrainConfig, tree: dict, device="cuda",
                    num_filters: int = 64) -> TrainState:
    """A JAX `MocoState`'s contents, as numpy trees, -> the port's
    `TrainState` on `device`. `tree` holds `step`, `params_q`,
    `batch_stats_q`, `params_k`, `batch_stats_k`, `queue` (K, dim),
    `queue_ptr` and, optionally, `trace`: the optax SGD trace over the
    query encoder's params (the `"enc"` entry of the TraceState), which
    becomes SGD's `momentum_buffer`s by the same layout rules."""
    def encoder(params, stats):
        enc = build_encoder(config.moco, num_filters=num_filters)
        enc.load_state_dict(encoder_from_flax(params, stats))
        return enc

    state = create_state(
        config, encoder(tree["params_q"], tree["batch_stats_q"]), device=device,
        encoder_k=encoder(tree["params_k"], tree["batch_stats_k"]),
        queue=torch.from_numpy(np.array(tree["queue"], np.float32)),
        step=int(np.asarray(tree["step"])), queue_ptr=int(np.asarray(tree["queue_ptr"])),
    )
    if tree.get("trace") is not None:
        params = dict(state.encoder_q.named_parameters())
        trace = encoder_from_flax(tree["trace"])
        if trace.keys() != params.keys():
            raise ValueError(f"trace leaves {sorted(set(trace) ^ set(params))} do not match")
        for name, buf in trace.items():
            p = params[name]  # the buffer takes the parameter's device and layout
            state.optimizer.state[p]["momentum_buffer"] = torch.empty_like(p).copy_(buf)
    return state
