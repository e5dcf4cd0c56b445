"""MTGNN, the graph-learning temporal convolution network (port of
raindrop_tpu/baselines/mtgnn.py; reference code/baselines/models.py:836-979
and code/baselines/layer.py). The published driver's configuration
(MTGNN_baseline.py:281-289): gcn_depth 2, node_dim T, conv = residual 16,
skip 32, end 64, dilation exponential 2, kernels [2, 3, 6, 7], 5 layers,
in_dim 1 (values only), a non-affine layer norm; the classifier one
Linear over the nodes' outputs (plus the statics).

  * the graph constructor (layer.py:152-190): learned node embeddings ->
    relu(tanh(alpha * (M1 M2^T - M2 M1^T))), each row's top k kept (k
    clamped to the node count). In training U[0, 1) noise times 0.01 is
    added before the top k (layer.py:186): the caller draws it
    (`ModelSeeds.graph_noise`, utils/dropout.py);
  * the dilated inception (layer.py:133-149): four dilated convolutions
    (kernels 2/3/6/7), truncated to the shortest output, concatenated;
  * the mixprop GCN (layer.py:55-76) and the per-sample layer norm over
    [C, N, T_l] (layer.py:297).

Every convolution has a kernel one row high (1 x k, NCHW, VALID: the JAX
package's lax.conv_general_dilated), so each is one matrix product over
the k dilated shifts of its input (`_conv2d`). Its gradient is matrix
products and a gather too, so a training step on the card repeats bit for
bit, where cuDNN's default weight gradient adds with float atomics. The
static settings are an `MTGNNSpec`, outside the parameter tree.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as Fn

from raindrop_tpu_torch.nn.init import generator_on, uniform
from raindrop_tpu_torch.utils.dropout import ModelSeeds, dropout

KERNEL_SET = (2, 3, 6, 7)


def receptive_field(layers: int, q: int, kernel: int = 7) -> int:
    """models.py:861-864."""
    if q > 1:
        return int(1 + (kernel - 1) * (q ** layers - 1) / (q - 1))
    return layers * (kernel - 1) + 1


@dataclass(frozen=True)
class MTGNNSpec:
    """The JAX tree's `_meta`, plus the widths the init reads."""
    n_nodes: int
    seq_length: int
    n_classes: int
    d_static: int = 0
    gcn_depth: int = 2
    node_dim: Optional[int] = None
    conv_channels: int = 16
    residual_channels: int = 16
    skip_channels: int = 32
    end_channels: int = 64
    layers: int = 5
    dilation_exponential: int = 2
    subgraph_size: int = 20
    tanhalpha: float = 3.0
    propalpha: float = 0.05
    in_dim: int = 1

    @property
    def rf(self) -> int:
        return receptive_field(self.layers, self.dilation_exponential)

    @property
    def k(self) -> int:
        return min(self.subgraph_size, self.n_nodes)


def _conv_init(gen, c_in, c_out, kh, kw, device):
    """torch Conv2d's default init: kaiming-uniform(a=sqrt 5), fan-in bias."""
    fan_in = c_in * kh * kw
    bw = math.sqrt(6.0 / ((1 + 5) * fan_in / 2))
    bb = 1.0 / math.sqrt(fan_in)
    return {"w": uniform(gen, (c_out, c_in, kh, kw), -bw, bw, device),
            "b": uniform(gen, (c_out,), -bb, bb, device)}


def mtgnn_init(generator, spec: MTGNNSpec, device="cuda"):
    gen = generator_on(generator, device)
    node_dim = spec.node_dim or spec.seq_length
    t_eff = max(spec.seq_length, spec.rf)
    res, conv, skip = spec.residual_channels, spec.conv_channels, spec.skip_channels
    params = {
        "gc": {
            "emb1": torch.randn((spec.n_nodes, node_dim), generator=gen, device=device),
            "emb2": torch.randn((spec.n_nodes, node_dim), generator=gen, device=device),
            "lin1": _conv_init(gen, node_dim, node_dim, 1, 1, device),
            "lin2": _conv_init(gen, node_dim, node_dim, 1, 1, device),
        },
        "start_conv": _conv_init(gen, spec.in_dim, res, 1, 1, device),
        "skip0": _conv_init(gen, spec.in_dim, skip, 1, t_eff, device),
        "layers": [],
    }
    cout4 = conv // len(KERNEL_SET)
    mix = (spec.gcn_depth + 1) * conv
    for j in range(1, spec.layers + 1):
        t_j = t_eff - receptive_field(j, spec.dilation_exponential) + 1
        params["layers"].append({
            "filter": [_conv_init(gen, res, cout4, 1, k, device) for k in KERNEL_SET],
            "gate": [_conv_init(gen, res, cout4, 1, k, device) for k in KERNEL_SET],
            "skip": _conv_init(gen, conv, skip, 1, t_j, device),
            "gconv1_mlp": _conv_init(gen, mix, res, 1, 1, device),
            "gconv2_mlp": _conv_init(gen, mix, res, 1, 1, device),
        })
    params["skipE"] = _conv_init(gen, res, skip, 1, t_eff - spec.rf + 1, device)
    params["end1"] = _conv_init(gen, skip, spec.end_channels, 1, 1, device)
    params["end2"] = _conv_init(gen, spec.end_channels, 1, 1, 1, device)
    # the classifier over the nodes' outputs (+ statics), models.py:925-927
    fan = spec.n_nodes + spec.d_static
    bw = 1.0 / math.sqrt(fan)
    params["mlp_out"] = {"w": uniform(gen, (spec.n_classes, fan), -bw, bw, device),
                         "b": uniform(gen, (spec.n_classes,), -bw, bw, device)}
    return params


def _conv2d(p, x, dilation: int = 1):
    """A 1 x k convolution of x [B, C, N, T] (VALID, dilated along T) as
    one product: the k shifts of the input, a view of it, against the
    weight [O, C, 1, k] -> [B, O, N, T - dilation * (k - 1)]."""
    k = p["w"].shape[3]
    shifts = x.unfold(3, dilation * (k - 1) + 1, 1)[..., ::dilation]
    out = torch.einsum("bcntk,ock->bont", shifts, p["w"][:, :, 0])
    return out + p["b"][:, None, None]


def _graph(params, spec: MTGNNSpec, noise: Optional[torch.Tensor] = None):
    gc = params["gc"]
    a = spec.tanhalpha
    v1 = torch.tanh(a * (gc["emb1"] @ gc["lin1"]["w"][:, :, 0, 0].T + gc["lin1"]["b"]))
    v2 = torch.tanh(a * (gc["emb2"] @ gc["lin2"]["w"][:, :, 0, 0].T + gc["lin2"]["b"]))
    adj = torch.relu(torch.tanh(a * (v1 @ v2.T - v2 @ v1.T)))
    score = (adj.detach() if noise is None
             else adj.detach() + noise.to(adj.device, adj.dtype) * 0.01)
    idx = torch.argsort(-score, dim=1, stable=True)[:, :spec.k]
    keep = torch.zeros_like(score).scatter_(1, idx, 1.0)
    return adj * keep


def _mixprop(mlp, x, adj, gdep, alpha):
    """layer.py:55-76: out = 1x1conv(concat_l (a x + (1-a) A_norm h_l))."""
    A = adj + torch.eye(adj.shape[0], device=adj.device, dtype=adj.dtype)
    A = A / A.sum(dim=1, keepdim=True)
    h = x
    outs = [h]
    for _ in range(gdep):
        h = alpha * x + (1 - alpha) * torch.einsum("ncwl,vw->ncvl", h, A)
        outs.append(h)
    return _conv2d(mlp, torch.cat(outs, dim=1))


def _inception(convs, x, dilation):
    outs = [_conv2d(p, x, dilation) for p in convs]
    t_min = outs[-1].shape[3]
    return torch.cat([o[..., -t_min:] for o in outs], dim=1)


def _layer_norm_3d(x):
    """Non-affine layer norm over (C, N, T) per sample (MTGNN_baseline.py:284)."""
    mu = x.mean(dim=(1, 2, 3), keepdim=True)
    var = x.var(dim=(1, 2, 3), keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + 1e-5)


def mtgnn_apply(
    params, spec: MTGNNSpec,
    values: torch.Tensor,        # [B, T, N] values (already normalised)
    static: Optional[torch.Tensor] = None,
    *,
    dropout_rate: float = 0.3,
    train: bool = False,
    seeds: Optional[ModelSeeds] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (logits, 0). `seeds` (train): `embed` drops the input, `steps[i]`
    layer i (JAX: r_drop and fold_in(r_drop, i)), `graph_noise` [N, N] the
    graph's noise."""
    B, T, N = values.shape
    x = values.transpose(1, 2)[:, None]                # [B, 1, N, T] (in_dim 1)
    if T < spec.rf:                                     # left-pad (models.py:934)
        x = Fn.pad(x, (spec.rf - T, 0))
    drop = train and seeds is not None
    rate = dropout_rate if drop else 0.0
    adj = _graph(params, spec, seeds.graph_noise if drop else None)

    skip = _conv2d(params["skip0"], dropout(seeds.embed, x, rate) if drop else x)
    h = _conv2d(params["start_conv"], x)
    for i, lp in enumerate(params["layers"]):
        residual = h
        dilation = spec.dilation_exponential ** i
        h = (torch.tanh(_inception(lp["filter"], h, dilation))
             * torch.sigmoid(_inception(lp["gate"], h, dilation)))
        if drop:
            h = dropout(seeds.steps[i], h, rate)
        skip = skip + _conv2d(lp["skip"], h)
        h = (_mixprop(lp["gconv1_mlp"], h, adj, spec.gcn_depth, spec.propalpha)
             + _mixprop(lp["gconv2_mlp"], h, adj.T, spec.gcn_depth, spec.propalpha))
        h = h + residual[..., -h.shape[3]:]
        h = _layer_norm_3d(h)

    skip = _conv2d(params["skipE"], h) + skip
    h = torch.relu(_conv2d(params["end1"], torch.relu(skip)))
    out = _conv2d(params["end2"], h)[:, 0, :, 0]       # [B, N]
    if static is not None:
        out = torch.cat([out, static], dim=1)
    logits = out @ params["mlp_out"]["w"].T + params["mlp_out"]["b"]
    return logits, logits.new_zeros(())
