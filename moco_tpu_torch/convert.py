"""Weights across the two packages: Flax encoder trees <-> the port's state_dict.

The layout rules are those of moco_tpu/export.py (resnet_to_torchvision)
and moco_tpu/import_torch.py (head_from_torch), kept here as a copy:

- conv kernels (H, W, Cin, Cout) -> (Cout, Cin, H, W)
- dense kernels (Cin, Cout) -> (Cout, Cin)
- BatchNorm: scale -> weight, bias -> bias, mean -> running_mean,
  var -> running_var; LayerNorm: scale -> weight, bias -> bias
- attention: the q/k/v kernels (D, H, Dh) -> (H*Dh, D), their biases
  (H, Dh) -> (H*Dh,), the out kernel (H, Dh, D) -> (D, H*Dh)

Flax trees come in as nested dicts of numpy arrays (or anything
`np.asarray` takes): `{"backbone": ..., "head": ...}` for the params and
for the batch statistics (a ViT backbone has none). A tree shaped like the
params without statistics (optax's momentum trace, Adam's moments) goes
through the same rules with `batch_stats=None`. `*_to_flax` are the
inverses (`backbone_to_flax`, `head_to_flax`, `encoder_to_flax`): the port's
tensors back into Flax trees of numpy arrays, for the JAX package's tools.

Both directions only move and transpose float32 values, so a round trip is
exact. Parity tests that run one input through a JAX module and the port's
counterpart compare in float32 at a tolerance the test states: 1e-5 for a
single layer or a head, 1e-4 for a whole encoder's features (two
implementations of the same convolutions sum in different orders), each
relative to values of order one.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from moco_tpu_torch.core.moco import (
    V3_HIDDEN,
    TrainState,
    build_encoder,
    build_predictor,
    create_state,
    shard_state,
)
from moco_tpu_torch.models.resnet import _CONFIGS
from moco_tpu_torch.models.vit import _VIT_CONFIGS
from moco_tpu_torch.parallel.mesh import World
from moco_tpu_torch.parallel.zero import unshard_leaf_host
from moco_tpu_torch.utils.config import MocoConfig, TrainConfig
from moco_tpu_torch.utils.device import resolve_device


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


def _dense(out: dict, name: str, params) -> None:
    out[f"{name}.weight"] = _np(params["kernel"]).T
    if "bias" in params:
        out[f"{name}.bias"] = _np(params["bias"])


def head_from_flax(params: Any, stats: Any = None) -> Dict[str, np.ndarray]:
    """ProjectionHead tree -> `fc.*` (v1) or `fc.0.*` / `fc.2.*` (v2);
    V3MLPHead tree and statistics -> `fc{i}.weight` and `bn{i}.*` (the
    last BN is affine-free: statistics only)."""
    if "BatchNorm_0" in params:  # V3MLPHead
        out = {}
        for name in params:
            if name.startswith("Dense_"):
                _dense(out, f"fc{name[6:]}", params[name])
        for name in set(params) | set(stats or {}):
            if name.startswith("BatchNorm_"):
                bn, p = f"bn{name[10:]}", params.get(name)
                if p is not None:
                    out[f"{bn}.weight"], out[f"{bn}.bias"] = _np(p["scale"]), _np(p["bias"])
                if stats is not None:
                    out[f"{bn}.running_mean"] = _np(stats[name]["mean"])
                    out[f"{bn}.running_var"] = _np(stats[name]["var"])
        return out
    if "Dense_1" in params:
        pairs = (("fc.0", params["Dense_0"]), ("fc.2", params["Dense_1"]))
    else:
        pairs = (("fc", params["Dense_0"]),)
    out = {}
    for name, dense in pairs:
        _dense(out, name, dense)
    return out


def vit_from_flax(params: Any) -> Dict[str, np.ndarray]:
    """Flax VisionTransformer params -> the port's `VisionTransformer` names
    (`patch_embed`, `cls_token`, `blocks.{i}.{norm1, attn.{query, key,
    value, out}, norm2, mlp.{fc1, fc2}}`, `final_norm`)."""
    out = {"patch_embed.weight": _conv(params["patch_embed"]["kernel"]),
           "patch_embed.bias": _np(params["patch_embed"]["bias"])}
    if "cls_token" in params:
        out["cls_token"] = _np(params["cls_token"])

    def norm(name, p):
        out[f"{name}.weight"], out[f"{name}.bias"] = _np(p["scale"]), _np(p["bias"])

    for i in range(sum(k.startswith("block_") for k in params)):
        bp, pre = params[f"block_{i}"], f"blocks.{i}"
        norm(f"{pre}.norm1", bp["LayerNorm_0"])
        norm(f"{pre}.norm2", bp["LayerNorm_1"])
        attn = bp["MultiHeadDotProductAttention_0"]
        for proj in ("query", "key", "value"):
            kernel = _np(attn[proj]["kernel"])  # (D, H, Dh)
            out[f"{pre}.attn.{proj}.weight"] = kernel.reshape(kernel.shape[0], -1).T
            out[f"{pre}.attn.{proj}.bias"] = _np(attn[proj]["bias"]).reshape(-1)
        kernel = _np(attn["out"]["kernel"])  # (H, Dh, D)
        out[f"{pre}.attn.out.weight"] = kernel.reshape(-1, kernel.shape[-1]).T
        out[f"{pre}.attn.out.bias"] = _np(attn["out"]["bias"])
        _dense(out, f"{pre}.mlp.fc1", bp["MlpBlock_0"]["Dense_0"])
        _dense(out, f"{pre}.mlp.fc2", bp["MlpBlock_0"]["Dense_1"])
    norm("final_norm", params["final_norm"])
    return out


def _tensors(sd: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}


def encoder_from_flax(params: Any, batch_stats: Any = None) -> Dict[str, torch.Tensor]:
    """Flax `MoCoEncoder` variables -> the port's `MoCoEncoder` state_dict
    (`backbone.*` in torchvision or ViT names, `head.*`); parameters only
    when `batch_stats` is None."""
    stats = {} if batch_stats is None else batch_stats
    if "patch_embed" in params["backbone"]:
        backbone = vit_from_flax(params["backbone"])
    else:
        backbone = backbone_from_flax(params["backbone"], stats.get("backbone"))
    sd = {f"backbone.{k}": v for k, v in backbone.items()}
    head_stats = None if batch_stats is None else stats.get("head")
    sd.update({f"head.{k}": v for k, v in head_from_flax(params["head"], head_stats).items()})
    return _tensors(sd)


def predictor_from_flax(params: Any, batch_stats: Any = None) -> Dict[str, torch.Tensor]:
    """Flax v3 predictor (a V3MLPHead) variables -> the port's predictor
    state_dict."""
    return _tensors(head_from_flax(params, batch_stats))


def _rng_dense(rng, cin: int, cout: int, bias: bool = True) -> dict:
    """LeCun-normal kernel (Flax's Dense init) and a zero bias."""
    p = {"kernel": (rng.standard_normal((cin, cout)) / np.sqrt(cin)).astype(np.float32)}
    if bias:
        p["bias"] = np.zeros(cout, np.float32)
    return p


def _rng_bn_stats(rng, c: int) -> dict:
    return {"mean": (0.1 * rng.standard_normal(c)).astype(np.float32),
            "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}


def _random_resnet(rng, cfg: MocoConfig, num_filters: int) -> tuple[dict, dict, int]:
    """(params, batch_stats, feature width) of a Flax ResNet backbone."""
    spec = _CONFIGS[cfg.arch]
    bottleneck = spec["block"].__name__ == "Bottleneck"
    expansion = 4 if bottleneck else 1

    def conv(k, cin, cout):
        return {"kernel": (rng.standard_normal((k, k, cin, cout)) * np.sqrt(2.0 / (k * k * cout))
                           ).astype(np.float32)}

    def bn(c):
        p = {"scale": np.ones(c, np.float32), "bias": np.zeros(c, np.float32)}
        return p, _rng_bn_stats(rng, c)

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
    return params, stats, cin


def _random_vit(rng, cfg: MocoConfig) -> tuple[dict, int]:
    """(params, width) of a Flax VisionTransformer: LeCun-normal kernels
    (the patch embedding's too, Flax's Conv init), zero biases, LayerNorm
    scale 1 and bias 0, cls_token N(0, 0.02)."""
    spec = _VIT_CONFIGS[cfg.arch]
    width, heads, patch = spec["hidden_dim"], spec["num_heads"], cfg.vit_patch_size or 16
    zeros = lambda *shape: np.zeros(shape, np.float32)  # noqa: E731
    ln = lambda: {"scale": np.ones(width, np.float32), "bias": zeros(width)}  # noqa: E731
    fan_in = patch * patch * 3
    params = {"patch_embed": {
        "kernel": (rng.standard_normal((patch, patch, 3, width)) / np.sqrt(fan_in)).astype(np.float32),
        "bias": zeros(width)}}
    if cfg.vit_pool == "cls":
        params["cls_token"] = (0.02 * rng.standard_normal((1, 1, width))).astype(np.float32)
    head_dim = width // heads
    for i in range(spec["depth"]):
        attn = {proj: {"kernel": (rng.standard_normal((width, heads, head_dim)) / np.sqrt(width)
                                  ).astype(np.float32), "bias": zeros(heads, head_dim)}
                for proj in ("query", "key", "value")}
        attn["out"] = {"kernel": (rng.standard_normal((heads, head_dim, width)) / np.sqrt(width)
                                  ).astype(np.float32), "bias": zeros(width)}
        params[f"block_{i}"] = {
            "LayerNorm_0": ln(), "MultiHeadDotProductAttention_0": attn, "LayerNorm_1": ln(),
            "MlpBlock_0": {"Dense_0": _rng_dense(rng, width, spec["mlp_dim"]),
                           "Dense_1": _rng_dense(rng, spec["mlp_dim"], width)},
        }
    params["final_norm"] = ln()
    return params, width


def _random_v3_head(rng, cin: int, num_layers: int, hidden: int, dim: int,
                    last_bn: bool) -> tuple[dict, dict]:
    """(params, batch_stats) of a Flax V3MLPHead: bias-free LeCun-normal
    Dense layers, BN scale 1 and bias 0 with statistics near (0, 1), the
    last BN (with `last_bn`) affine-free."""
    params, stats = {}, {}
    widths = [cin] + [hidden] * (num_layers - 1) + [dim]
    for i in range(num_layers):
        params[f"Dense_{i}"] = _rng_dense(rng, widths[i], widths[i + 1], bias=False)
        if i < num_layers - 1:
            c = widths[i + 1]
            params[f"BatchNorm_{i}"] = {"scale": np.ones(c, np.float32),
                                        "bias": np.zeros(c, np.float32)}
            stats[f"BatchNorm_{i}"] = _rng_bn_stats(rng, c)
    if last_bn:
        stats[f"BatchNorm_{num_layers - 1}"] = _rng_bn_stats(rng, dim)
    return params, stats


def random_flax_encoder(cfg: MocoConfig, seed: int = 0,
                        num_filters: int = 64) -> tuple[dict, dict]:
    """(params, batch_stats) of a Flax `MoCoEncoder` made with numpy from
    `seed`: a ResNet (He-normal fan_out convs as the Flax init, BN scale 1
    and bias 0, running statistics drawn near (0, 1)) or a ViT
    (`_random_vit`), and the v1/v2 head (LeCun-normal dense kernels, zero
    biases) or the v3 head (`_random_v3_head`, 3 layers behind a ViT).
    Random weights in the exact tree a trained checkpoint has, so they
    reach the port through `encoder_from_flax` like real ones."""
    rng = np.random.default_rng(seed)
    if cfg.arch.startswith("vit"):
        (backbone, cin), bstats = _random_vit(rng, cfg), {}
    else:
        backbone, rstats, cin = _random_resnet(rng, cfg, num_filters)
        bstats = {"backbone": rstats}
    if cfg.v3:
        layers = 3 if cfg.arch.startswith("vit") else 2
        head, hstats = _random_v3_head(rng, cin, layers, V3_HIDDEN, cfg.dim, True)
        return {"backbone": backbone, "head": head}, {**bstats, "head": hstats}
    head = ({"Dense_0": _rng_dense(rng, cin, cin), "Dense_1": _rng_dense(rng, cin, cfg.dim)}
            if cfg.mlp else {"Dense_0": _rng_dense(rng, cin, cfg.dim)})
    return {"backbone": backbone, "head": head}, bstats


def random_flax_predictor(cfg: MocoConfig, seed: int = 0) -> tuple[dict, dict]:
    """(params, batch_stats) of v3's Flax predictor (`build_predictor`'s
    2-layer V3MLPHead), made with numpy from `seed`."""
    return _random_v3_head(np.random.default_rng(seed), cfg.dim, 2, V3_HIDDEN, cfg.dim,
                           cfg.arch.startswith("vit"))


def _full_like(tree, template):
    """`tree` with each leaf in ZeRO's (n, m) layout (a shape other than
    `template`'s) unsharded to the template's shape, as JAX's
    `unshard_tree_host` does; other leaves as they are."""
    if isinstance(template, dict):
        return {k: _full_like(tree[k], v) for k, v in template.items()}
    if np.shape(tree) != np.shape(template):
        return unshard_leaf_host(tree, np.shape(template))
    return tree


def state_from_flax(config: TrainConfig, tree: dict, device="cuda",
                    num_filters: int = 64, world=None,
                    mlp_hidden: Optional[int] = None) -> TrainState:
    """A JAX `MocoState`'s contents, as numpy trees, -> the port's
    `TrainState` on `device`. `tree` holds `step`, `params_q`,
    `batch_stats_q`, `params_k` and `batch_stats_k`; for v1/v2 also
    `queue` (K, dim), `queue_ptr` and, optionally, `trace`: the optax
    trace over the query encoder's params (the `"enc"` entry of the
    TraceState: SGD's, or under `optimizer="lars"` the last element of
    `optax.lars`'s chain), which becomes SGD's `momentum_buffer`s, or
    LARS's `trace`s, by the same layout rules; for v3 `params_pred`, `batch_stats_pred` and, optionally, `adam`:
    {"mu", "nu", "count"} of optax's ScaleByAdamState over {"enc", "pred"},
    which become AdamW's `exp_avg`, `exp_avg_sq` and `step` for every
    trained parameter. A v3 head takes its hidden width from the tree's
    first Dense kernel (v1/v2 heads have no such width), or from
    `mlp_hidden`. `world` (parallel/mesh.py) makes the encoders' and the
    predictor's SyncBNs as `build_encoder` does, and on a model axis the
    state holds its model rank's rows of the (whole) queue.

    The tree may be a ZeRO state's: parameters and optimizer moments in
    the (n, m) layout are unsharded with the full shapes, as
    `unshard_tree_host` does (a v3 tree so needs `mlp_hidden`); the port's
    state is then sharded over `world`'s data ranks by `config`'s ZeRO
    fields (`core/moco.py::shard_state`), on a (data, model) mesh too (n
    is its num_data), with the queue's rows sharded over its model ranks."""
    def hidden(head):
        return mlp_hidden if mlp_hidden is not None else np.shape(head["Dense_0"]["kernel"])[-1]

    def encoder(params, stats):
        enc = build_encoder(config.moco, num_filters=num_filters,
                            mlp_hidden=hidden(tree["params_q"]["head"]), world=world)
        heads = next((m.num_heads for m in enc.modules() if hasattr(m, "num_heads")), None)
        template = encoder_to_flax(enc.state_dict(), heads)[0]
        enc.load_state_dict(encoder_from_flax(_full_like(params, template), stats))
        return enc, template

    zero = config.parallel.shard_weight_update
    replicated = dataclasses.replace(config, parallel=dataclasses.replace(
        config.parallel, shard_weight_update=False, zero_layer_granular=False))
    step = int(np.asarray(tree["step"]))
    (enc_q, template), (enc_k, _) = (encoder(tree[f"params_{s}"], tree[f"batch_stats_{s}"])
                                     for s in "qk")
    if not config.moco.v3:
        state = create_state(
            replicated, enc_q, device=device, encoder_k=enc_k,
            queue=torch.from_numpy(np.array(tree["queue"], np.float32)),
            step=step, queue_ptr=int(np.asarray(tree["queue_ptr"])), world=world,
        )
        if tree.get("trace") is not None:
            key = "trace" if config.optim.optimizer == "lars" else "momentum_buffer"
            _load_moments(state, {key: encoder_from_flax(_full_like(tree["trace"], template))},
                          {})
    else:
        predictor = build_predictor(config.moco, mlp_hidden=hidden(tree["params_q"]["head"]),
                                    world=world)
        pred_template = head_to_flax(predictor.state_dict())[0]
        predictor.load_state_dict(predictor_from_flax(
            _full_like(tree["params_pred"], pred_template), tree["batch_stats_pred"]))
        state = create_state(replicated, enc_q, device=device, encoder_k=enc_k, step=step,
                             predictor=predictor)
        adam = tree.get("adam")
        if adam is not None:
            moments = {"exp_avg": adam["mu"], "exp_avg_sq": adam["nu"]}
            _load_moments(
                state, {n: encoder_from_flax(_full_like(m["enc"], template))
                        for n, m in moments.items()},
                {n: predictor_from_flax(_full_like(m["pred"], pred_template))
                 for n, m in moments.items()},
                step=float(np.asarray(adam["count"])))
    if zero:
        state = shard_state(state, config, world or World(device=resolve_device(device)))
    return state


def _load_moments(state: TrainState, enc: dict, pred: dict, step=None) -> None:
    """Fill the optimizer state of every trained parameter from converted
    moment trees ({state key: {param name: tensor}} for the query encoder
    and the predictor); each buffer takes its parameter's device and
    layout. AdamW also takes its `step` count."""
    for moments, module in ((enc, state.encoder_q), (pred, state.predictor)):
        params = {n: p for n, p in module.named_parameters() if p.requires_grad} if moments else {}
        for key, tree in moments.items():
            missing = set(params) - set(tree)
            if missing:
                raise ValueError(f"{key}: no leaves for {sorted(missing)}")
            for name, p in params.items():
                state.optimizer.state[p][key] = torch.empty_like(p).copy_(tree[name])
                if step is not None:
                    state.optimizer.state[p]["step"] = torch.tensor(step, dtype=torch.float32)


def _flatten_tree(tree: dict, prefix: tuple = ()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten_tree(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def flax_param_paths(module: torch.nn.Module) -> Dict[str, tuple]:
    """{parameter name: its Flax leaf path} of a `MoCoEncoder` (paths under
    `backbone` / `head`) or a head such as v3's predictor, by this module's
    layout rules: each parameter, filled with its ordinal, goes through
    `encoder_to_flax` / `head_to_flax`, and each Flax leaf then names the
    parameter it came from. Every parameter has exactly one leaf."""
    params = list(module.named_parameters())
    tagged = {n: np.full(tuple(p.shape), i, np.float32) for i, (n, p) in enumerate(params)}
    if any(n.startswith("backbone.") for n in tagged):
        heads = next((m.num_heads for m in module.modules() if hasattr(m, "num_heads")), None)
        tree = encoder_to_flax(tagged, heads)[0]
    else:
        tree = head_to_flax(tagged)[0]
    out: Dict[str, tuple] = {}
    for path, leaf in _flatten_tree(tree).items():
        name = params[int(np.asarray(leaf).flat[0])][0]
        if name in out:
            raise ValueError(f"parameter {name} maps to two Flax leaves: {out[name]}, {path}")
        out[name] = path
    missing = sorted({n for n, _ in params} - set(out))
    if missing:
        raise ValueError(f"parameters without a Flax leaf: {missing}")
    return out



# ----------------------------------------------------- the way back to Flax


def _np_of(t) -> np.ndarray:
    return np.array(t.detach().cpu() if isinstance(t, torch.Tensor) else t, np.float32)


def _kernel(w) -> np.ndarray:
    return _np_of(w).transpose(2, 3, 1, 0)  # (Cout, Cin, H, W) -> (H, W, Cin, Cout)


def _bn_to(sd: dict, name: str) -> tuple[dict, dict]:
    params = {"scale": _np_of(sd[f"{name}.weight"]), "bias": _np_of(sd[f"{name}.bias"])}
    stats = {}
    if f"{name}.running_mean" in sd:
        stats = {"mean": _np_of(sd[f"{name}.running_mean"]),
                 "var": _np_of(sd[f"{name}.running_var"])}
    return params, stats


def _convbn_to(sd: dict, conv: str, bn: str) -> tuple[dict, dict]:
    bp, bs = _bn_to(sd, bn)
    params = {"Conv_0": {"kernel": _kernel(sd[f"{conv}.weight"])}, "BatchNorm_0": bp}
    return params, ({"BatchNorm_0": bs} if bs else {})


def backbone_to_flax(sd: dict) -> tuple[dict, dict]:
    """Torchvision-named ResNet tensors -> (params, batch_stats) of the Flax
    ResNet, the inverse of `backbone_from_flax`: a 3x3 `conv1` is the CIFAR
    stem (`ConvBN_0`), a 7x7 one the ImageNet stem (`Conv_0`,
    `BatchNorm_0`); blocks are numbered across stages in order, and a
    block with `conv3` is a Bottleneck. Without running statistics in `sd`
    the stats tree is empty."""
    params, stats = {}, {}

    def put(name, pair):
        params[name] = pair[0]
        if pair[1]:
            stats[name] = pair[1]

    if np.shape(sd["conv1.weight"])[-1] == 3:  # CIFAR stem
        put("ConvBN_0", _convbn_to(sd, "conv1", "bn1"))
    else:
        params["Conv_0"] = {"kernel": _kernel(sd["conv1.weight"])}
        put("BatchNorm_0", _bn_to(sd, "bn1"))
    bottleneck = "layer1.0.conv3.weight" in sd
    block, n_main = ("Bottleneck", 3) if bottleneck else ("BasicBlock", 2)
    idx, stage = 0, 1
    while f"layer{stage}.0.conv1.weight" in sd:
        j = 0
        while f"layer{stage}.{j}.conv1.weight" in sd:
            pre, bp, bs = f"layer{stage}.{j}", {}, {}
            convs = [(f"{pre}.conv{c + 1}", f"{pre}.bn{c + 1}") for c in range(n_main)]
            if f"{pre}.downsample.0.weight" in sd:
                convs.append((f"{pre}.downsample.0", f"{pre}.downsample.1"))
            for c, (conv, bn) in enumerate(convs):
                bp[f"ConvBN_{c}"], s = _convbn_to(sd, conv, bn)
                if s:
                    bs[f"ConvBN_{c}"] = s
            params[f"{block}_{idx}"] = bp
            if bs:
                stats[f"{block}_{idx}"] = bs
            idx, j = idx + 1, j + 1
        stage += 1
    return params, stats


def _dense_to(sd: dict, name: str) -> dict:
    out = {"kernel": _np_of(sd[f"{name}.weight"]).T}
    if f"{name}.bias" in sd:
        out["bias"] = _np_of(sd[f"{name}.bias"])
    return out


def head_to_flax(sd: dict) -> tuple[dict, dict]:
    """`fc.*` / `fc.0.*` + `fc.2.*` (ProjectionHead) or `fc{i}` + `bn{i}`
    (V3MLPHead, the last BN statistics only) -> (params, batch_stats), the
    inverse of `head_from_flax`."""
    if "fc0.weight" in sd:  # V3MLPHead
        params, stats = {}, {}
        i = 0
        while f"fc{i}.weight" in sd:
            params[f"Dense_{i}"] = _dense_to(sd, f"fc{i}")
            i += 1
        for i in range(i):
            bn = f"bn{i}"
            if f"{bn}.weight" in sd:
                params[f"BatchNorm_{i}"] = {"scale": _np_of(sd[f"{bn}.weight"]),
                                            "bias": _np_of(sd[f"{bn}.bias"])}
            if f"{bn}.running_mean" in sd:
                stats[f"BatchNorm_{i}"] = {"mean": _np_of(sd[f"{bn}.running_mean"]),
                                           "var": _np_of(sd[f"{bn}.running_var"])}
        return params, stats
    if "fc.0.weight" in sd:
        return {"Dense_0": _dense_to(sd, "fc.0"), "Dense_1": _dense_to(sd, "fc.2")}, {}
    return {"Dense_0": _dense_to(sd, "fc")}, {}


def vit_to_flax(sd: dict, num_heads: int) -> dict:
    """The port's ViT names -> Flax VisionTransformer params, the inverse
    of `vit_from_flax`; `num_heads` splits the attention widths."""
    out = {"patch_embed": {"kernel": _kernel(sd["patch_embed.weight"]),
                           "bias": _np_of(sd["patch_embed.bias"])}}
    if "cls_token" in sd:
        out["cls_token"] = _np_of(sd["cls_token"])

    def norm(name):
        return {"scale": _np_of(sd[f"{name}.weight"]), "bias": _np_of(sd[f"{name}.bias"])}

    i = 0
    while f"blocks.{i}.norm1.weight" in sd:
        pre, attn = f"blocks.{i}", {}
        for proj in ("query", "key", "value"):
            w = _np_of(sd[f"{pre}.attn.{proj}.weight"])  # (H*Dh, D)
            attn[proj] = {"kernel": w.T.reshape(w.shape[1], num_heads, -1),
                          "bias": _np_of(sd[f"{pre}.attn.{proj}.bias"]).reshape(num_heads, -1)}
        w = _np_of(sd[f"{pre}.attn.out.weight"])  # (D, H*Dh)
        attn["out"] = {"kernel": w.T.reshape(num_heads, -1, w.shape[0]),
                       "bias": _np_of(sd[f"{pre}.attn.out.bias"])}
        out[f"block_{i}"] = {
            "LayerNorm_0": norm(f"{pre}.norm1"), "LayerNorm_1": norm(f"{pre}.norm2"),
            "MultiHeadDotProductAttention_0": attn,
            "MlpBlock_0": {"Dense_0": _dense_to(sd, f"{pre}.mlp.fc1"),
                           "Dense_1": _dense_to(sd, f"{pre}.mlp.fc2")},
        }
        i += 1
    out["final_norm"] = norm("final_norm")
    return out


def encoder_to_flax(sd: dict, num_heads: Optional[int] = None) -> tuple[dict, dict]:
    """The port's `MoCoEncoder` state_dict -> (params, batch_stats) of the
    Flax `MoCoEncoder`, the inverse of `encoder_from_flax`. A ViT backbone
    needs `num_heads` and has no statistics; a tree without any statistics
    gives an empty batch_stats."""
    backbone = {k[9:]: v for k, v in sd.items() if k.startswith("backbone.")}
    head = {k[5:]: v for k, v in sd.items() if k.startswith("head.")}
    params, stats = {}, {}
    if "patch_embed.weight" in backbone:
        if num_heads is None:
            raise ValueError("a ViT backbone needs num_heads")
        params["backbone"] = vit_to_flax(backbone, num_heads)
    else:
        params["backbone"], bstats = backbone_to_flax(backbone)
        if bstats:
            stats["backbone"] = bstats
    params["head"], hstats = head_to_flax(head)
    if hstats:
        stats["head"] = hstats
    return params, stats


def vit_to_timm(sd: dict, patch_size: int, image_size: int = 224) -> Dict[str, np.ndarray]:
    """The port's ViT backbone tensors -> timm `vision_transformer` names,
    the same names and values as `moco_tpu/export.py:148` `vit_to_timm`:
    the q/k/v projections fused into `attn.qkv` with rows ordered
    [q; k; v], `out` as `attn.proj`, the patch embedding as
    `patch_embed.proj`, `final_norm` as `norm`, and the fixed 2-D sin-cos
    position embedding for `image_size` exported as timm's `pos_embed`
    (with a cls slot only where the backbone has a cls token: gap pooling
    exports no `cls_token`). The MLP is tanh-GELU: build the timm model
    with `act_layer=partial(nn.GELU, approximate='tanh')` to reproduce the
    forward."""
    from moco_tpu_torch.models.vit import sincos_2d_posembed

    out = {"patch_embed.proj.weight": _np_of(sd["patch_embed.weight"]),
           "patch_embed.proj.bias": _np_of(sd["patch_embed.bias"])}
    dim = out["patch_embed.proj.bias"].shape[0]
    has_cls = "cls_token" in sd
    if has_cls:
        out["cls_token"] = _np_of(sd["cls_token"])
    out["pos_embed"] = sincos_2d_posembed(dim, image_size // patch_size, cls_token=has_cls)
    i = 0
    while f"blocks.{i}.norm1.weight" in sd:
        pre = f"blocks.{i}"
        for name in ("norm1", "norm2", "mlp.fc1", "mlp.fc2"):
            for leaf in ("weight", "bias"):
                out[f"{pre}.{name}.{leaf}"] = _np_of(sd[f"{pre}.{name}.{leaf}"])
        for leaf in ("weight", "bias"):
            out[f"{pre}.attn.qkv.{leaf}"] = np.concatenate(
                [_np_of(sd[f"{pre}.attn.{p}.{leaf}"]) for p in ("query", "key", "value")])
            out[f"{pre}.attn.proj.{leaf}"] = _np_of(sd[f"{pre}.attn.out.{leaf}"])
        i += 1
    out["norm.weight"] = _np_of(sd["final_norm.weight"])
    out["norm.bias"] = _np_of(sd["final_norm.bias"])
    return out
