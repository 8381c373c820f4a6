"""ResNet-50 (config 3) for the PyTorch port: the port of the JAX
package's ``models/resnet.py``.

Bottleneck blocks [3, 4, 6, 3] (v1.5: the stride sits on the 3x3 conv),
batch norm whose running statistics live in a state tree beside the
parameters, and an f32 head on the spatial mean.  The trees keep JAX's
key paths, a stage's list of blocks keyed by the block's index
(``"stage1/0/conv2"``); conv weights are stored OIHW, torch's layout,
where JAX keeps HWIO (``params_from_numpy`` / ``params_to_numpy``), and
images are NCHW (the card may hand ``channels_last`` tensors).

The numerics follow JAX's:

- ``"SAME"`` padding is JAX's, asymmetric at stride 2
  (``same_pads``: the smaller half before), applied with ``F.pad``; the
  3x3/2 max pool pads with -inf.
- ``_bn`` in training normalizes with the f32 batch mean and the biased
  batch variance, and moves the running statistics as ``0.9 * old + 0.1
  * batch`` toward the biased variance; ``(x - mean) / sqrt(var + 1e-5)
  * scale + bias`` runs in f32 and is cast back.  With ``train=False`` it
  uses the running statistics.
- Across processes (a ``mesh``: data parallel) the batch statistics are
  those of the global batch: the sum of x and the element count are
  summed over the data axes, then the sum of squared deviations from the
  global mean (two passes, as JAX's ``jnp.var``), with gradients that
  flow back through both sums (``collectives.psum_data``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from trainingjob_operator_tpu_torch import resolve_device
from trainingjob_operator_tpu_torch.parallel.collectives import (
    psum_data,
    sum_over_data,
)


@dataclass(frozen=True)
class ResNetConfig:
    """Own copy of the JAX package's ``ResNetConfig`` (same fields and
    defaults: ResNet-50)."""

    num_classes: int = 1000
    stage_sizes: Tuple[int, ...] = (3, 4, 6, 3)
    width: int = 64
    dtype: str = "bfloat16"

    @classmethod
    def resnet50(cls) -> "ResNetConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "ResNetConfig":
        return cls(num_classes=10, stage_sizes=(1, 1), width=8)

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


#: The configs by their ``RESNET_CONFIG`` names.
CONFIGS = {"tiny": ResNetConfig.tiny, "resnet50": ResNetConfig.resnet50}

#: BN momentum and epsilon (JAX's ``_bn`` defaults).
MOMENTUM, EPS = 0.9, 1e-5


def _blocks(config: ResNetConfig):
    """(stage, block, cin, cout, stride) of every bottleneck block."""
    cin = config.width
    for s, n in enumerate(config.stage_sizes):
        cout = config.width * (2 ** s)
        for b in range(n):
            yield s, b, cin, cout, (2 if (s > 0 and b == 0) else 1)
            cin = cout * 4


def _final_channels(config: ResNetConfig) -> int:
    return config.width * (2 ** (len(config.stage_sizes) - 1)) * 4


def init_params(config: ResNetConfig, generator: Optional[torch.Generator],
                device="cuda") -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(params, stats) in JAX's trees, f32: convs He-normal (``normal *
    sqrt(2 / fan_in)``, fan_in = kh kw cin), the head ``normal * 0.01``
    and its bias 0, BN scale 1 and bias 0, running mean 0 and var 1.
    Drawn on the generator's device in tree order (a CPU generator gives
    the same numbers on every device), moved to ``device``.  Without a
    ``generator`` the weights are allocated, not drawn (a restore's
    template)."""
    dev = resolve_device(device)

    def conv(kh, kw, cin, cout):
        shape = (cout, cin, kh, kw)
        if generator is None:
            return torch.empty(shape, device=dev)
        w = torch.randn(shape, generator=generator, device=generator.device)
        return (w * math.sqrt(2.0 / (kh * kw * cin))).to(dev)

    def bn(c):
        return {"scale": torch.ones(c, device=dev),
                "bias": torch.zeros(c, device=dev)}

    def bn_state(c):
        return {"mean": torch.zeros(c, device=dev),
                "var": torch.ones(c, device=dev)}

    c = config
    params: Dict[str, Any] = {"stem": {"conv": conv(7, 7, 3, c.width),
                                       "bn": bn(c.width)}}
    stats: Dict[str, Any] = {"stem": bn_state(c.width)}
    for s, b, cin, cout, _ in _blocks(c):
        p = {"conv1": conv(1, 1, cin, cout), "bn1": bn(cout),
             "conv2": conv(3, 3, cout, cout), "bn2": bn(cout),
             "conv3": conv(1, 1, cout, cout * 4), "bn3": bn(cout * 4)}
        st = {"bn1": bn_state(cout), "bn2": bn_state(cout),
              "bn3": bn_state(cout * 4)}
        if b == 0:
            p["proj"] = conv(1, 1, cin, cout * 4)
            p["proj_bn"] = bn(cout * 4)
            st["proj_bn"] = bn_state(cout * 4)
        params.setdefault(f"stage{s}", {})[str(b)] = p
        stats.setdefault(f"stage{s}", {})[str(b)] = st
    cin = _final_channels(c)
    if generator is None:
        w = torch.empty((cin, c.num_classes), device=dev)
    else:
        w = (torch.randn((cin, c.num_classes), generator=generator,
                         device=generator.device) * 0.01).to(dev)
    params["head"] = {"w": w, "b": torch.zeros(c.num_classes, device=dev)}
    return params, stats


def _convert(tree, leaf, path=""):
    """A JAX tree (dicts and lists) as the port's dict tree, ``leaf(path,
    x)`` applied to each leaf; a list's items are keyed by their index."""
    if isinstance(tree, (list, tuple)):
        tree = {str(i): v for i, v in enumerate(tree)}
    if isinstance(tree, dict):
        return {k: _convert(v, leaf, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    return leaf(path, tree)


def _is_conv(path: str) -> bool:
    name = path.rsplit("/", 1)[-1]
    return name.startswith("conv") or name == "proj"


def params_from_numpy(params: Dict[str, Any],
                      stats: Optional[Dict[str, Any]] = None,
                      device="cuda"):
    """JAX's (params, stats) trees (numpy leaves, lists of blocks) -> the
    port's, f32 on ``device``: conv weights HWIO -> OIHW.  Returns
    ``(params, stats)``; ``stats`` None where none was given."""
    dev = resolve_device(device)

    def leaf(path, x):
        t = torch.from_numpy(np.array(x, dtype=np.float32))
        if _is_conv(path):
            t = t.permute(3, 2, 0, 1).contiguous()
        return t.to(dev)

    return (_convert(params, leaf),
            None if stats is None else _convert(stats, leaf))


def params_to_numpy(tree: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The port's parameter-shaped tree (parameters, gradients, momenta)
    flattened to ``{path: numpy}`` in JAX's layout (conv weights HWIO)."""
    from trainingjob_operator_tpu_torch.parallel import sharding

    out = {}
    for path, x in sharding.tree_paths(tree):
        x = x.detach().float().cpu()
        if _is_conv(path):
            x = x.permute(2, 3, 1, 0)
        out[path] = x.numpy()
    return out


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """JAX's ``"SAME"`` pads of one spatial dim (``lax.padtype_to_pads``):
    total = max((ceil(size / stride) - 1) * stride + k - size, 0), the
    smaller half before."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x, k: int, stride: int, value: float = 0.0):
    (top, bottom), (left, right) = (same_pads(x.shape[2], k, stride),
                                    same_pads(x.shape[3], k, stride))
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom), value=value)
    return x


def _conv(x, w, stride: int = 1):
    """``lax.conv_general_dilated(x, w.astype(x.dtype), stride, "SAME")``
    on NCHW ``x`` and OIHW ``w``."""
    x = _pad_same(x, w.shape[-1], stride)
    return F.conv2d(x, w.to(x.dtype), stride=stride)


def _max_pool(x):
    """JAX's 3x3/2 ``reduce_window`` max with "SAME" padding at -inf."""
    return F.max_pool2d(_pad_same(x, 3, 2, value=-math.inf), 3, 2)


def _bn(x, p, s, train: bool, mesh=None):
    """Returns (y, new_state); the new state is detached (JAX's aux)."""
    xf = x.float()
    if train:
        dims = (0, 2, 3)
        total = xf.sum(dims)
        count = torch.tensor(float(xf.numel() // xf.shape[1]),
                             device=x.device)
        if mesh is not None:
            total = psum_data(total, mesh)
            with torch.no_grad():
                count = sum_over_data(count, mesh)
        mean = total / count
        centered = xf - mean[:, None, None]
        sq = centered.square().sum(dims)
        if mesh is not None:
            sq = psum_data(sq, mesh)
        var = sq / count
        with torch.no_grad():
            new_s = {"mean": MOMENTUM * s["mean"] + (1 - MOMENTUM) * mean,
                     "var": MOMENTUM * s["var"] + (1 - MOMENTUM) * var}
    else:
        mean, var = s["mean"], s["var"]
        centered = xf - mean[:, None, None]
        new_s = s
    inv = torch.reciprocal(torch.sqrt(var + EPS))
    y = (centered * inv[:, None, None] * p["scale"][:, None, None]
         + p["bias"][:, None, None])
    return y.to(x.dtype), new_s


def forward(params: Dict[str, Any], stats: Dict[str, Any],
            images: torch.Tensor, config: ResNetConfig, train: bool = True,
            mesh=None):
    """images [B, 3, H, W] -> (logits [B, classes] f32, new_stats).  With
    a ``mesh`` the images are this rank's rows, the batch statistics the
    global batch's."""
    x = images.to(config.compute_dtype)
    new_stats: Dict[str, Any] = {}
    x = _conv(x, params["stem"]["conv"], stride=2)
    x, new_stats["stem"] = _bn(x, params["stem"]["bn"], stats["stem"], train,
                               mesh)
    x = _max_pool(torch.relu(x))
    for s, b, _, _, stride in _blocks(config):
        p, st = params[f"stage{s}"][str(b)], stats[f"stage{s}"][str(b)]
        residual = x
        y = _conv(x, p["conv1"])
        y, st1 = _bn(y, p["bn1"], st["bn1"], train, mesh)
        y = _conv(torch.relu(y), p["conv2"], stride=stride)
        y, st2 = _bn(y, p["bn2"], st["bn2"], train, mesh)
        y = _conv(torch.relu(y), p["conv3"])
        y, st3 = _bn(y, p["bn3"], st["bn3"], train, mesh)
        new_st = {"bn1": st1, "bn2": st2, "bn3": st3}
        if "proj" in p:
            residual = _conv(x, p["proj"], stride=stride)
            residual, new_st["proj_bn"] = _bn(residual, p["proj_bn"],
                                              st["proj_bn"], train, mesh)
        x = torch.relu(y + residual)
        new_stats.setdefault(f"stage{s}", {})[str(b)] = new_st
    x = x.float().mean((2, 3))
    logits = x @ params["head"]["w"] + params["head"]["b"]
    return logits, new_stats


def loss_fn(params: Dict[str, Any], stats: Dict[str, Any],
            batch: Dict[str, torch.Tensor], config: ResNetConfig, mesh=None):
    """(mean softmax CE, new_stats) of batch {"images" [B, 3, H, W],
    "labels" [B]}.  With a ``mesh`` the batch is this rank's rows and the
    loss the global mean: each rank's mean over its rows, over the data
    size, summed over the data axes (``sum_over_data``)."""
    logits, new_stats = forward(params, stats, batch["images"], config,
                                train=True, mesh=mesh)
    loss = F.cross_entropy(logits, batch["labels"].long())
    if mesh is None:
        return loss, new_stats
    return sum_over_data(loss / mesh.data_size(), mesh), new_stats


def num_params(config: ResNetConfig) -> int:
    params, _ = init_params(config, None, "cpu")
    from trainingjob_operator_tpu_torch.workloads.train import tree_leaves

    return sum(x.numel() for x in tree_leaves(params))
