"""Operations and bytes of the cells' work, reckoned from the shapes of a
configuration (the ``Arch`` of its layout, ``benchmark/layouts/``), whatever
kernels run.

Operations are those of the matrix products and convolutions, ``2 m n k``
each, as ``torch.utils.flop_counter.FlopCounterMode`` counts them on the
plain reference (a causal product counted whole, as the reference computes
it). The attention rooflines count each input and output byte once, and
the causal products over the half that the mask leaves.
"""

from __future__ import annotations


def _out(size, k, s, p):
    return (size + 2 * p - k) // s + 1


def _conv(c_out, c_in_per_group, k, hw):
    return 2 * c_out * hw * hw * c_in_per_group * k * k


def msclips_image_flops(a):
    """One image through MS-CLIP-S's ``encode_image``: stem, branch,
    adapters, trunk, projection."""
    W, R = a.width, a.resolution
    n = len(a.stem_strides)
    total = 0
    h = _out(R, a.first_k, 2, (a.first_k - 1) // 2)
    total += _conv(W >> n, 3, a.first_k, h)
    for i, s in enumerate(a.stem_strides):
        c = W >> (n - i)
        h = _out(h, 3, s, 1)
        total += _conv(2 * c, c, 3, h) + _conv(2 * c, c, 1, h)
    total += _conv(W, W, 1, h)
    g = h
    ins = [3, W // 16, W // 8, W // 4, W // 2]
    outs = [W // 16, W // 8, W // 4, W // 2, W]
    top = R
    for i in range(len(a.lateral_layers)):
        k, s, p = a.par_kernels[i], a.par_strides[i], a.par_paddings[i]
        new = _out(top, k, s, p)
        if i == 0:
            total += _conv(outs[0], 3, k, new)
        else:
            mid = outs[i] // 2
            total += (_conv(mid, ins[i], 1, top) + _conv(mid, mid, k, new)
                      + _conv(outs[i], mid, 1, new)
                      + _conv(outs[i], ins[i], 1, new))
        top = new
        t2b = _out(top, a.t2b_kernels[i], a.t2b_strides[i], a.t2b_paddings[i])
        total += _conv(outs[i], 1, a.t2b_kernels[i], t2b)
        total += _conv(W, outs[i], 1, t2b) + _conv(W, 1, 3, g)
    total += a.attention_blocks * block_flops(W, a.seq)
    return total + 2 * W * a.embed


def vit_image_flops(a):
    """One image through a plain ViT's ``encode_image``: the patchify
    convolution, the blocks, the projection."""
    return (_conv(a.width, 3, a.patch, a.grid)
            + a.attention_blocks * block_flops(a.width, a.seq)
            + 2 * a.width * a.embed)


def block_flops(width, seq):
    """One sequence through a block: the four projections and the two
    attention products."""
    return 24 * width * width * seq + 4 * seq * seq * width


def text_flops(a):
    """One caption through ``encode_text``."""
    return a.text_layers * block_flops(a.text_width, a.context) \
        + 2 * a.text_width * a.embed


def eval_flops_per_image(a, classes):
    """``encode_image`` and the logits against ``classes`` classes."""
    return a.image_flops() + 2 * a.embed * classes


def train_flops_per_sample(a, batch):
    """Forward and backward, three times the forward: both towers and the
    ``[batch, batch]`` logits of the loss. Recomputation is not counted."""
    return 3 * (a.image_flops() + text_flops(a) + 2 * batch * a.embed)


def attention_fwd_cost(batch, seq, width, heads, causal, dtype_bytes=2):
    """``(operations, bytes)`` of the attention core forward on ``[batch,
    seq, 3 width]`` -> ``[batch, seq, width]``: ``QK^T`` and ``PV``."""
    pairs = seq * (seq + 1) // 2 if causal else seq * seq
    flops = 4 * batch * pairs * width
    nbytes = batch * seq * 4 * width * dtype_bytes
    if causal:
        nbytes += seq * seq * 4  # the float32 additive mask
    return flops, nbytes


def attention_bwd_cost(batch, seq, width, heads, causal, dtype_bytes=2):
    """``(operations, bytes)`` of the backward from ``qkv`` and the output
    gradient to ``dqkv``: ``QK^T`` again, then ``dV``, ``dP``, ``dQ`` and
    ``dK``."""
    pairs = seq * (seq + 1) // 2 if causal else seq * seq
    flops = 10 * batch * pairs * width
    nbytes = batch * seq * (3 + 1 + 3) * width * dtype_bytes
    if causal:
        nbytes += seq * seq * 4
    return flops, nbytes


def roofline_seconds(cost, peak_flops, peak_bytes):
    """The least time of ``cost = (operations, bytes)`` on the device."""
    flops, nbytes = cost
    return max(flops / peak_flops, nbytes / peak_bytes)
