"""Probabilistic and per-timestep losses of the mTAND tier (the port of
raindrop_tpu/nn/losses.py; reference code/baselines/mTAND/utils.py).

Masked Gaussian log-density, diagonal Gaussian KL, masked MSE, the ELBO
terms of the encoder-decoder mTAND variant (compute_losses,
utils.py:107-123) and the per-timestep cross-entropy of activity
classification (compute_pertp_loss, utils.py:818-829). Plain torch
functions of tensors on any device; autograd goes through them.
"""

from __future__ import annotations

import math

import torch

_LOG_2PI = math.log(2.0 * math.pi)


def log_normal_pdf(x, mean, logvar, mask):
    """Elementwise masked Gaussian log-density
    (reference mTAND/utils.py:29-33)."""
    return -0.5 * (_LOG_2PI + logvar + (x - mean) ** 2 / torch.exp(logvar)) * mask


def normal_kl(mu1, lv1, mu2, lv2):
    """Elementwise KL(N(mu1, e^lv1) || N(mu2, e^lv2))
    (reference mTAND/utils.py:35-42)."""
    v1, v2 = torch.exp(lv1), torch.exp(lv2)
    return lv2 / 2.0 - lv1 / 2.0 + (v1 + (mu1 - mu2) ** 2) / (2.0 * v2) - 0.5


def masked_mse(orig, pred, mask):
    """sum((orig-pred)^2 * mask) / sum(mask)
    (reference mTAND/utils.py:45-48)."""
    return torch.sum((orig - pred) ** 2 * mask) / torch.sum(mask)


def vae_elbo_terms(dim, batch, qz0_mean, qz0_logvar, pred_x,
                   noise_std: float, normalize: bool = False):
    """Per-sample (log p(x|z), KL(q(z0|x) || N(0, I))) for the mTAND
    encoder-decoder (reference compute_losses, mTAND/utils.py:107-123).

    batch: [B, L, >=2*dim], values in columns :dim, the observed mask in
    dim:2dim; qz0_mean / qz0_logvar: the latent posterior's statistics,
    any shape [B, ...]; pred_x: the decoder's reconstruction [B, L, dim];
    normalize: divide both terms by the sample's observation count (the
    reference's args.norm).
    """
    observed = batch[:, :, :dim]
    mask = batch[:, :, dim:2 * dim]
    noise_logvar = torch.full_like(pred_x, 2.0 * math.log(noise_std))
    logpx = log_normal_pdf(observed, pred_x, noise_logvar, mask).sum(dim=(-1, -2))
    kl = normal_kl(qz0_mean, qz0_logvar,
                   torch.zeros_like(qz0_mean), torch.zeros_like(qz0_logvar))
    kl = kl.reshape(kl.shape[0], -1).sum(dim=-1)
    if normalize:
        denom = mask.sum(dim=(-1, -2))
        logpx = logpx / denom
        kl = kl / denom
    return logpx, kl


def per_timestep_ce(label_predictions, true_label_onehot, mask):
    """Masked per-timestep cross-entropy (reference compute_pertp_loss,
    mTAND/utils.py:818-829): timesteps with no observation in any feature
    are left out; the labels arrive one-hot and are argmaxed.

    The intended masked mean sum(ce * valid) / sum(valid), as the JAX
    package computes it, not the reference's: its [N] x [N, 1] broadcast
    makes an [N, N] matrix, so its "masked mean" is the unmasked sum of the
    cross-entropy over the mask count (DEVIATIONS.md).

    label_predictions: [B, L, C] logits; true_label_onehot: [B, L, C];
    mask: [B, L, D] observation mask.
    """
    B, L, C = label_predictions.shape
    logits = label_predictions.reshape(B * L, C)
    target = torch.argmax(true_label_onehot.reshape(B * L, C), dim=-1)
    valid = (mask.sum(-1) > 0).reshape(B * L).to(logits.dtype)
    ce = -torch.log_softmax(logits, dim=-1).gather(1, target[:, None])[:, 0]
    return torch.sum(ce * valid) / torch.sum(valid)
