"""IP-Net, the interpolation-prediction network (port of
raindrop_tpu/baselines/ipnet.py; reference code/baselines/IP_Net/src/, the
reference's TensorFlow-1 Keras model):

  * single-channel interpolation (interpolation_layer.py:17-75): an RBF
    kernel interpolates each channel onto `ref_points` reference times with
    a softplus-positive learned bandwidth per channel, giving the smooth
    interpolant y, the log-intensity w and a kappa = 10 transient one;
  * cross-channel interpolation (:78-120): a softmax over the CHANNELS and a
    learned d x d mixing (identity at init) of the de-meaned smooth
    interpolants, giving [smooth, intensity, transient - smooth];
  * the classifier (IP_Net_baseline.py:80-96): a GRU (hid) over the
    interpolated sequence, a dense head; the autoencoder's reconstruction
    and its masked-MSE loss (:101-118) are `ipnet_reconstruction_loss`.

Input x [B, 4F, T], rows (values, mask, timestamps, held-out mask), the
Keras model's contract. The static settings (`ref_points`, `hours`) are an
`IPNetSpec`. The GRU is a Python loop over the reference points.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from raindrop_tpu_torch.baselines.mtand import gru_init, gru_scan
from raindrop_tpu_torch.nn.init import generator_on, torch_linear_params
from raindrop_tpu_torch.nn.linear import linear_apply


@dataclass(frozen=True)
class IPNetSpec:
    """The JAX tree's `_meta`: the reference grid's size and span (hours)."""
    ref_points: int = 192
    hours: float = 48.0


def ipnet_init(generator, num_features: int, *, hid: int = 100, n_classes: int = 2,
               device="cuda"):
    gen = generator_on(generator, device)
    return {
        "sci_kernel": torch.zeros((num_features,), device=device),   # 0 at init (:31)
        "cci_w": torch.eye(num_features, device=device),             # identity (:88)
        "gru": gru_init(gen, 3 * num_features, hid, device),
        "dense": torch_linear_params(gen, hid, n_classes, device),
    }


def _single_channel_interp(params, spec: IPNetSpec, x, *, reconstruction=False):
    """x [B, 4F, T] -> [B, 3F, R] (or [B, 2F, T] for the reconstruction)."""
    F = x.shape[1] // 4
    x_t = x[:, :F]                                     # values [B, F, T]
    d = x[:, 2 * F:3 * F]                              # timestamps
    if reconstruction:
        m = x[:, 3 * F:]                               # the held-out mask
        ref_t = d[:, :, None, :]                       # back onto the observed times
    else:
        m = x[:, F:2 * F]
        ref_t = torch.linspace(0.0, spec.hours, spec.ref_points,
                               device=x.device)[None, None, None, :]
    norm = (d[:, :, :, None] - ref_t) ** 2             # [B, F, T, R]
    # each reference point's squared distances less their least: the
    # softmax over T is the same, and the bandwidth's gradient no longer
    # sums terms of the distances' size (thousands of hours^2) that cancel
    # to a small one; the least comes back in w
    near = norm.amin(dim=2)                            # [B, F, R]
    alpha = torch.nn.functional.softplus(params["sci_kernel"])[None, :, None, None]
    # 1e-30 stays a normal f32 (1e-38 would flush to zero: log(0) = -inf)
    log_m = torch.log(torch.clamp(m, min=1e-30))[:, :, :, None]

    def interp(kappa):
        logits = -kappa * alpha * (norm - near[:, :, None, :]) + log_m
        w = torch.logsumexp(logits, dim=2)            # [B, F, R]
        wt = torch.exp(logits - w[:, :, None, :])
        return (wt * x_t[:, :, :, None]).sum(dim=2), w - kappa * alpha[:, :, :, 0] * near

    y, w = interp(1.0)
    if reconstruction:
        return torch.cat([y, w], dim=1)
    y_trans, _ = interp(10.0)
    return torch.cat([y, w, y_trans], dim=1)


def _cross_channel_interp(params, x, *, reconstruction=False):
    """x [B, 3F, R] -> [B, 3F, R] (or [B, F, T] for the reconstruction). F
    is the layer's build-time width (interpolation_layer.py:84): the
    reconstruction's input is 2F wide but sliced with the same F."""
    F = params["cci_w"].shape[0]
    y = x[:, :F].transpose(1, 2)                       # [B, R, F]
    w = x[:, F:2 * F].transpose(1, 2)
    intensity = torch.exp(w)
    # the softmax over CHANNELS (interpolation_layer.py:104-107)
    w_norm = torch.exp(w - torch.logsumexp(w, dim=-1, keepdim=True))
    mean = y.mean(dim=1, keepdim=True)
    rep = ((w_norm * (y - mean)) @ params["cci_w"] + mean).transpose(1, 2)  # [B, F, R]
    if reconstruction:
        return rep
    return torch.cat([rep, intensity.transpose(1, 2), x[:, 2 * F:] - rep], dim=1)


def ipnet_apply(params, spec: IPNetSpec, x: torch.Tensor, *, train: bool = False,
                seeds=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, 4F, T] -> (logits [B, n_classes], the reconstruction [B, 2F, T])."""
    F = x.shape[1] // 4
    interp = _cross_channel_interp(params, _single_channel_interp(params, spec, x))
    single_rec = _single_channel_interp(params, spec, x, reconstruction=True)
    reconst = _cross_channel_interp(params, single_rec, reconstruction=True)
    h = gru_scan(params["gru"], interp.transpose(1, 2))   # over [B, R, 3F]
    logits = linear_apply(params["dense"], h)
    return logits, torch.cat([reconst, single_rec[:, F:]], dim=1)[:, :2 * F]


def ipnet_reconstruction_loss(x_true: torch.Tensor, reconst: torch.Tensor,
                              stds: torch.Tensor) -> torch.Tensor:
    """The masked, std-normalised MSE on the held-out observations
    (IP_Net_baseline.py:101-118). x_true [B, 4F, T]; reconst [B, >=F, T]."""
    F = x_true.shape[1] // 4
    y = x_true[:, :F]
    m = x_true[:, F:2 * F] * (1.0 - x_true[:, 3 * F:])
    err = ((y - reconst[:, :F]) ** 2) * m
    count = torch.clamp(m.sum(dim=2), min=1.0)
    per_chan = err.sum(dim=2) / count / (stds[None, :] ** 2)
    return (per_chan.sum(dim=1) / F).mean()
