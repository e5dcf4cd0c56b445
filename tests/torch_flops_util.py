"""The kernels' FLOP credit against PyTorch's count of plain versions.

Each `*_flops` function counts (utils/diagnostics.counted_flops) a forward
and its backward: with kernel=True through the port's wrapper (on a CUDA
tensor its kernels, which credit their FLOPs; on a CPU tensor its plain
versions, which credit nothing), with kernel=False through autograd over a
plain PyTorch form whose every product is a matmul that FlopCounterMode
sees. Imports no JAX: the card tests use it.
"""

import torch

from raindrop_tpu_torch.nn.transformer import _layer_init, transformer_encoder_layer_apply
from raindrop_tpu_torch.ops import flash_attention as fa
from raindrop_tpu_torch.ops import fused_encoder as fe
from raindrop_tpu_torch.ops import sparse as sp
from raindrop_tpu_torch.utils.diagnostics import counted_flops

FLOP_TOL = 0.02


def _leaf(gen, shape, device):
    return torch.randn(shape, generator=gen, device=device).requires_grad_(True)


def _backward(out, gen):
    g = torch.randn(out.shape, generator=gen, device=out.device)
    (out * g).sum().backward()


def _dense_attention(q, k, v):
    """softmax(q k^T / sqrt(D)) v over [..., T, D] heads."""
    s = (q @ k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    return torch.softmax(s, dim=-1) @ v


def _split_heads(x, nhead):
    B, T, d = x.shape
    return x.reshape(B, T, nhead, d // nhead).transpose(1, 2)


def packed_flops(B, T, d, nhead, device, kernel):
    """flash_mha_packed's forward and backward at [B, T, d] (all lengths T),
    or the plain attention's."""
    gen = torch.Generator(device=device).manual_seed(0)
    q, k, v = (_leaf(gen, (B, T, d), device) for _ in range(3))
    lengths = torch.full((B,), T, dtype=torch.int32, device=device)

    def run():
        if kernel:
            o = fa.flash_mha_packed(q, k, v, lengths, None, 0.0, "bfloat16", nhead)
        else:
            o = _dense_attention(*(_split_heads(x, nhead) for x in (q, k, v)))
        _backward(o, gen)

    return counted_flops(run)


def split_flops(B, H, T, D, device, kernel):
    """flash_mha's forward and backward at [B, H, T, D], or the plain
    attention's."""
    gen = torch.Generator(device=device).manual_seed(0)
    q, k, v = (_leaf(gen, (B, H, T, D), device) for _ in range(3))
    lengths = torch.full((B,), T, dtype=torch.int32, device=device)

    def run():
        if kernel:
            o = fa.flash_mha(q, k, v, lengths, None, 0.0, "bfloat16")
        else:
            o = _dense_attention(q, k, v)
        _backward(o, gen)

    return counted_flops(run)


def fused_flops(B, T, d, ffn, nhead, device, kernel):
    """fused_encoder_layer's forward and backward (x and every weight
    differentiable), or the plain layer's (the dense rung of
    nn/transformer)."""
    gen = torch.Generator(device=device).manual_seed(0)
    p = _layer_init(gen, d, ffn, device)
    for t in (p["in_proj_w"], p["in_proj_b"], *p["out_proj"].values(),
              *p["lin1"].values(), *p["lin2"].values(), *p["ln1"].values(),
              *p["ln2"].values()):
        t.requires_grad_(True)
    x = _leaf(gen, (B, T, d), device)
    lengths = torch.full((B,), T, dtype=torch.int32, device=device)

    def run():
        if kernel:
            out = fe.fused_encoder_layer(p, x, lengths, None, 0.0, "bfloat16", nhead)
        else:
            out = transformer_encoder_layer_apply(p, x, None, nhead, backend="dense")
        _backward(out, gen)

    return counted_flops(run)


def complete_graph(N, device):
    """The complete graph on N nodes, edges target-major: (src, dst)."""
    n = torch.arange(N, device=device)
    return n.repeat(N), n.repeat_interleave(N)


def spmm_flops(B, N, D, device, kernel, gather_target=False):
    """spmm_segment_softmax's forward and backward (dx and dgamma) on the
    complete graph, or the plain dense form: the softmax weights as a
    [B, N, N] matrix times the source rows (a bmm)."""
    gen = torch.Generator(device=device).manual_seed(0)
    x = _leaf(gen, (B, N, D), device)
    gamma = _leaf(gen, (B, N * N), device)
    src, dst = complete_graph(N, device)

    def run():
        if kernel:
            out, _ = sp.spmm_segment_softmax(x, gamma, src, dst, n_nodes=N,
                                             gather_target=gather_target)
        else:
            w = torch.softmax(gamma.reshape(B, N, N), dim=-1)   # [b, dst, src]
            out = w @ x
        _backward(out, gen)

    return counted_flops(run)


def sddmm_flops(B, N, D, device, kernel):
    """sddmm's forward and backward on the complete graph, or the plain
    dense form: q k^T (a bmm) read at the edges."""
    gen = torch.Generator(device=device).manual_seed(0)
    q, k = (_leaf(gen, (B, N, D), device) for _ in range(2))
    src, dst = complete_graph(N, device)

    def run():
        if kernel:
            alpha = sp.sddmm(q, k, src, dst, 0.5)
        else:
            alpha = 0.5 * (q @ k.transpose(1, 2))[:, dst, src]
        _backward(alpha, gen)

    return counted_flops(run)


def credit_cases():
    """(name, the credit the wrapper gives for a forward and its backward,
    the plain count's function and arguments) at small shapes."""
    # P12's attention width, PAM's layer and head dim, a small graph
    B, T, H, N, D = 3, 40, 2, 6, 16
    return [
        ("flash_mha_packed", 3 * fa.attention_flops(B, T, 160),
         packed_flops, (B, T, 160, H)),
        ("flash_mha", 3 * fa.attention_flops(B, T, H * 42),
         split_flops, (B, H, T, 42)),
        ("fused_encoder_layer", 3 * fe.layer_flops(B, T, 84, 136),
         fused_flops, (B, T, 84, 136, H)),
        ("spmm_segment_softmax", 3 * sp.edge_flops(B, N * N, D),
         spmm_flops, (B, N, D)),
        ("sddmm", 3 * sp.edge_flops(B, N * N, D), sddmm_flops, (B, N, D)),
    ]
