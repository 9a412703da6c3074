"""CrackFormer, the SegNet-shaped transformer head (`csbsr_tpu/models/crackformer.py`).

Five Down / five Up stages of bottlenecked TFBlocks (local self-attention
and a convolutional MLP, GroupNorm everywhere), window-local
max_pool_with_indices / max_unpool pairs between them, five attention-gated
side outputs fused into the final map. forward returns (sigmoid(fuse),
sides): sides stacks the five sigmoid side maps on the channel axis (the
aux target). GELU is exact (erf); GroupNorm uses C // 4 groups, eps 1e-5;
the MLP's two dropouts (0.3) act in train mode with the step's generator.
Five pool levels need H and W divisible by 32. Tensors are NCHW.

Down3/4/5 of the reference declare a third block (`nn3`) but call the
second block twice. As in the JAX package, this module declares no `nn3`
there and applies `nn2` twice, so its state dict has no `downN.nn3` keys:
the converter emits none and `load_state_dict(strict=True)` of a converted
tree is clean. A released reference `.pth` does carry them (parameters the
reference never uses); `utils/convert.drop_unused_reference_keys` removes
them before a strict load (the test CLI does so). The Up stages use all
three blocks.

LocalSABlock (u = 1): queries (heads x k), keys (k) and values (v) are 1x1
convs with GroupNorm; the keys take a softmax over the h*w positions; the
content term is q . (softmax(keys) . values) and the positional term runs the
(k, 1, 1, m, m) embedding as a conv over each value channel separately (the
value channel folded into the batch). Plain matmuls and softmax: the JAX
package composes them in XLA, not in a Pallas kernel.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .blocks import (Conv2d, Dropout, GroupNorm, conv2d, lecun_normal_, max_pool_with_indices,
                     max_unpool)
from .unet import ConvRelu
from ..ops.resize import resize


def _gn(c: int) -> GroupNorm:
    return GroupNorm(max(c // 4, 1), c, eps=1e-5)


class _DWConv(nn.Module):
    """The reference's DWConv wrapper: a 3x3 conv in groups of four channels."""

    def __init__(self, ch, generator=None):
        super().__init__()
        self.dwconv = Conv2d(ch, ch, 3, 1, 1, groups=max(ch // 4, 1))
        lecun_normal_(self.dwconv.weight, generator)
        nn.init.zeros_(self.dwconv.bias)

    def forward(self, x):
        return self.dwconv(x)


class Mlp(nn.Module):
    """1x1 -> GN -> grouped 3x3 -> GN -> GELU -> dropout -> 1x1 -> GN -> dropout."""

    def __init__(self, channels, drop=0.3, generator=None):
        super().__init__()
        g, hidden = generator, channels // 4
        self.fc1 = conv2d(channels, hidden, 1, generator=g)
        self.gn1 = _gn(hidden)
        self.dwconv = _DWConv(hidden, g)
        self.gn2 = _gn(hidden)
        self.fc2 = conv2d(hidden, channels, 1, generator=g)
        self.gn3 = _gn(channels)
        self.drop1, self.drop2 = Dropout(drop), Dropout(drop)

    def forward(self, x, generator=None):
        x = self.gn2(self.dwconv(self.gn1(self.fc1(x))))
        x = self.drop1(F.gelu(x), generator)
        return self.drop2(self.gn3(self.fc2(x)), generator)


class LocalSABlock(nn.Module):
    """Linear-attention content plus local conv context (see the module
    docstring); out channels = heads * (channels // heads)."""

    def __init__(self, channels, heads=4, k=16, m=7, generator=None):
        super().__init__()
        g = generator
        self.heads, self.kk, self.vv, self.m = heads, k, channels // heads, m

        def conv_gn(c):
            return nn.Sequential(conv2d(channels, c, 1, bias=False, generator=g), _gn(c))

        self.queries = conv_gn(k * heads)
        self.keys = conv_gn(k)
        self.values = conv_gn(self.vv)
        self.embedding = nn.Parameter(torch.empty(k, 1, 1, m, m).normal_(0.0, 1.0, generator=g))

    def forward(self, x):
        b, _, h, w = x.shape
        n, kk, vv = h * w, self.kk, self.vv
        q = self.queries(x).reshape(b, self.heads, kk, n)
        soft = torch.softmax(self.keys(x).reshape(b, kk, n), dim=-1)
        values = self.values(x)
        content = torch.einsum("bkn,bvn->bkv", soft, values.reshape(b, vv, n))
        content = torch.einsum("bhkn,bkv->bhvn", q, content)
        emb = self.embedding[:, 0].to(x.dtype)  # (k, 1, m, m)
        ctx = F.conv2d(values.reshape(b * vv, 1, h, w), emb, padding=(self.m - 1) // 2)
        context = torch.einsum("bhkn,bvkn->bhvn", q, ctx.reshape(b, vv, kk, n))
        return (content + context).reshape(b, self.heads * vv, h, w)


class TFBlock(nn.Module):
    """x + attn(x), then x + mlp(x) (drop_path 0)."""

    def __init__(self, channels, generator=None):
        super().__init__()
        self.attn = LocalSABlock(channels, generator=generator)
        self.mlp = Mlp(channels, generator=generator)

    def forward(self, x, generator=None):
        x = x + self.attn(x)
        return x + self.mlp(x, generator)


class Bottleneck(nn.Module):
    """1x1 in (no bias) -> GN -> GELU -> TFBlock -> GELU -> 1x1 out (no bias)
    -> GN -> GELU, plus the shortcut (1x1 conv + GN where the width changes).
    The TFBlock sits at `conv2.0`, the reference's name."""

    def __init__(self, in_planes, planes, generator=None):
        super().__init__()
        g = generator
        hidden = max(planes, in_planes) // 4
        self.conv1 = conv2d(in_planes, hidden, 1, bias=False, generator=g)
        self.bn1 = _gn(hidden)
        self.conv2 = nn.ModuleList([TFBlock(hidden, generator=g)])
        self.conv3 = conv2d(hidden, planes, 1, bias=False, generator=g)
        self.bn3 = _gn(planes)
        if in_planes != planes:
            self.shortcut = nn.Sequential(conv2d(in_planes, planes, 1, generator=g), _gn(planes))

    def forward(self, x, generator=None):
        out = F.gelu(self.bn1(self.conv1(x)))
        out = F.gelu(self.conv2[0](out, generator))
        out = F.gelu(self.bn3(self.conv3(out)))
        return out + (self.shortcut(x) if hasattr(self, "shortcut") else x)


class TransEB(nn.Module):
    """GELU(Bottleneck(x)); the Bottleneck at `.conv`."""

    def __init__(self, in_planes, planes, generator=None):
        super().__init__()
        self.conv = Bottleneck(in_planes, planes, generator=generator)

    def forward(self, x, generator=None):
        return F.gelu(self.conv(x, generator))


class LABlock(nn.Module):
    """Attention gate: sigmoid(GN(conv(GN(conv(GELU(sum of the inputs))))))."""

    def __init__(self, in_ch, out_ch, generator=None):
        super().__init__()
        g = generator
        self.W_1 = nn.Sequential(conv2d(in_ch, out_ch, 3, padding=1, generator=g), _gn(out_ch))
        self.psi = nn.Sequential(conv2d(out_ch, out_ch, 3, padding=1, generator=g), _gn(out_ch))

    def forward(self, inputs):
        s = F.gelu(sum(inputs))
        return torch.sigmoid(self.psi(self.W_1(s)))


class Fuse(nn.Module):
    """Side output: cat(down, up) -> 3x3 conv (64) + ReLU, times the
    attention, -> 3x3 conv (1), bilinear x `scale`."""

    def __init__(self, in_ch, scale, generator=None):
        super().__init__()
        g = generator
        self.scale = scale
        self.nn = ConvRelu(in_ch, 64, g)
        self.conv = conv2d(64, 1, 3, padding=1, generator=g)

    def forward(self, down_inp, up_inp, attention):
        out = attention * self.nn(torch.cat([down_inp, up_inp], dim=1))
        out = self.conv(out)
        if self.scale != 1:
            out = resize(out, (out.shape[2] * self.scale, out.shape[3] * self.scale),
                         method="bilinear")
        return out


class _Stage(nn.Module):
    """A Down or Up stage's blocks, at nn1, nn2[, nn3] (the reference's names)."""

    def __init__(self, blocks):
        super().__init__()
        for i, blk in enumerate(blocks, start=1):
            setattr(self, f"nn{i}", blk)


# (in, out) of each TransEB; down1.nn1 is a plain conv + ReLU
_DOWN = {1: [None, (64, 64)], 2: [(64, 128), (128, 128)], 3: [(128, 256), (256, 256)],
         4: [(256, 512), (512, 512)], 5: [(512, 512), (512, 512)]}
_UP = {5: [(512, 512), (512, 512), (512, 512)], 4: [(512, 512), (512, 512), (512, 256)],
       3: [(256, 256), (256, 256), (256, 128)], 2: [(128, 128), (128, 64)],
       1: [(64, 64), (64, 64)]}
_LA_IN = {1: 64, 2: 128, 3: 256, 4: 512, 5: 512}
_FUSE_IN = {5: 1024, 4: 768, 3: 384, 2: 192, 1: 128}


class CrackFormer(nn.Module):
    """forward(x, generator=None) -> (sigmoid(fuse) (B, 1, H, W), sides (B, 5, H, W))."""

    def __init__(self, generator=None):
        super().__init__()
        g = generator
        teb = lambda io: TransEB(io[0], io[1], generator=g)
        self.down1 = _Stage([ConvRelu(3, 64, g), teb(_DOWN[1][1])])
        for i in range(2, 6):
            setattr(self, f"down{i}", _Stage([teb(io) for io in _DOWN[i]]))
        for i in range(1, 6):
            setattr(self, f"up{i}", _Stage([teb(io) for io in _UP[i]]))
            setattr(self, f"LABlock_{i}", LABlock(_LA_IN[i], 64, generator=g))
            setattr(self, f"fuse{i}", Fuse(_FUSE_IN[i], 2 ** (i - 1), generator=g))
        self.final = conv2d(5, 1, 1, generator=g)

    def forward(self, x, generator=None):
        gen = generator
        # encoder; stages 3-5 apply nn2 twice, as the reference does
        s1_1 = self.down1.nn1(x)
        s1_2 = self.down1.nn2(s1_1, gen)
        out, idx1 = max_pool_with_indices(s1_2)
        s2_1 = self.down2.nn1(out, gen)
        s2_2 = self.down2.nn2(s2_1, gen)
        out, idx2 = max_pool_with_indices(s2_2)
        enc = {}
        for i in (3, 4, 5):
            stage = getattr(self, f"down{i}")
            a = stage.nn1(out, gen)
            b = stage.nn2(a, gen)
            c = stage.nn2(b, gen)
            enc[i] = (a, b, c)
            out, idx = max_pool_with_indices(c)
            enc[i] += (idx,)
        s3_1, s3_2, s3_3, idx3 = enc[3]
        s4_1, s4_2, s4_3, idx4 = enc[4]
        s5_1, s5_2, s5_3, idx5 = enc[5]

        # decoder
        dec = {}
        for i, idx in ((5, idx5), (4, idx4), (3, idx3)):
            stage = getattr(self, f"up{i}")
            a = stage.nn1(max_unpool(out, idx), gen)
            b = stage.nn2(a, gen)
            out = stage.nn3(b, gen)
            dec[i] = (a, b, out)
        s5_4, s5_5, up5 = dec[5]
        s4_4, s4_5, up4 = dec[4]
        s3_4, s3_5, up3 = dec[3]
        s2_3 = self.up2.nn1(max_unpool(out, idx2), gen)
        up2 = self.up2.nn2(s2_3, gen)
        s1_3 = self.up1.nn1(max_unpool(up2, idx1), gen)
        up1 = self.up1.nn2(s1_3, gen)

        # attention gates and side fusion
        att1 = self.LABlock_1([s1_1, s1_3])
        att2 = self.LABlock_2([s2_1, s2_3])
        att3 = self.LABlock_3([s3_1, s3_2, s3_4, s3_5])
        att4 = self.LABlock_4([s4_1, s4_2, s4_4, s4_5])
        att5 = self.LABlock_5([s5_1, s5_2, s5_4, s5_5])
        sides = [self.fuse5(s5_3, up5, att5), self.fuse4(s4_3, up4, att4),
                 self.fuse3(s3_3, up3, att3), self.fuse2(s2_2, up2, att2),
                 self.fuse1(s1_2, up1, att1)]
        fuse = self.final(torch.cat(sides, dim=1))
        return torch.sigmoid(fuse), torch.sigmoid(torch.cat(sides, dim=1))
