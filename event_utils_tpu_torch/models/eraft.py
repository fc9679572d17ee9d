"""E-RAFT: dense optical flow from a pair of event voxel grids.

Gehrig, Millhäusler, Gehrig and Scaramuzza, "E-RAFT: Dense Optical Flow
from Event Cameras", 3DV 2021 (arXiv:2108.10552;
github.com/uzh-rpg/E-RAFT ``model/eraft.py``): RAFT's large model (Teed
and Deng, ECCV 2020) over two consecutive voxel grids, in its ``standard``
mode (no warm start). Submodules carry E-RAFT's own names (``fnet``,
``cnet``, ``update_block.encoder.convc1``, ``update_block.gru.convz1``,
``update_block.flow_head.conv1``, ``update_block.mask.0``, ...), so its
state-dict keys name the parameters here; a strided residual block's norm
is registered twice, as ``norm3`` and ``downsample.1``, as there.

The forward pass, float32 with TF32 off (``_device.no_tf32``):

- encoders (``BasicEncoder``): a 7x7 stride-2 convolution to 64, norm,
  ReLU; two residual blocks each at 64, 96 (stride 2) and 128 (stride 2);
  a 1x1 convolution out. ``fnet`` (instance norm, no affine) runs on both
  grids in one batch, ``cnet`` (batch norm, eval statistics) on the
  later grid, E-RAFT's ``cnet(image2)``; its output splits into the
  hidden state (tanh) and the context (ReLU);
- the correlation volume ``fmap1^T fmap2 / sqrt(D)`` over the 1/8 grid
  and three 2x2 average pools of it (``eraft.corr``);
- ``iters`` refinements (``eraft.refine``): the 9x9 bilinear samples
  around ``coords1 / 2^l`` at each level (``grid_sample``,
  ``align_corners=True``, zeros outside; RAFT's ``meshgrid(dy, dx)``
  offset order, which the published weights assume), the motion encoder,
  the separable ConvGRU (1x5, then 5x1), the flow and mask heads, and
  ``coords1 += delta``;
- the last iteration's field upsampled x8 by the convex combination of
  its 3x3 neighbourhood (``eraft.upsample``), as RAFT's ``test_mode``:
  E-RAFT upsamples every iteration's field, which only training reads.

Counters: ``eraft.pairs`` (pairs through the network) and
``eraft.iterations`` (refinements, ``iters`` a pair).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .._device import no_tf32
from ..errors import ConfigurationError
from ..utils import profiling

_NORMS = {"instance": nn.InstanceNorm2d, "batch": nn.BatchNorm2d}
#: RAFT's large model, as E-RAFT builds it: feature, hidden and context
#: widths; pyramid levels and lookup radius
FEATURE_DIM, HIDDEN_DIM, CONTEXT_DIM = 256, 128, 128
CORR_LEVELS, CORR_RADIUS = 4, 4


class ResidualBlock(nn.Module):
    """RAFT's residual block: two 3x3 convolutions, each followed by the
    norm and a ReLU; a strided block takes its shortcut through a 1x1
    convolution and its own norm (``norm3``)."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str,
                 stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, padding=1,
                               stride=stride)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        norm = _NORMS[norm_fn]
        self.norm1 = norm(planes)
        self.norm2 = norm(planes)
        self.downsample = None
        if stride != 1:
            self.norm3 = norm(planes)
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride=stride), self.norm3)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """RAFT's feature and context encoder: 1/8 resolution,
    ``output_dim`` channels."""

    def __init__(self, in_channels: int, output_dim: int, norm_fn: str):
        super().__init__()
        self.norm1 = _NORMS[norm_fn](64)
        self.conv1 = nn.Conv2d(in_channels, 64, 7, stride=2, padding=3)
        layers, width = [], 64
        for planes, stride in ((64, 1), (96, 2), (128, 2)):
            layers.append(nn.Sequential(
                ResidualBlock(width, planes, norm_fn, stride),
                ResidualBlock(planes, planes, norm_fn, 1)))
            width = planes
        self.layer1, self.layer2, self.layer3 = layers
        self.conv2 = nn.Conv2d(128, output_dim, 1)

    def forward(self, x):
        x = F.relu(self.norm1(self.conv1(x)))
        return self.conv2(self.layer3(self.layer2(self.layer1(x))))


#: Outputs a ``WideConv2d`` computes, rounded up to a multiple of this.
#: Timed with cuDNN 9.22.0 (``torch.backends.cudnn.version()`` 92200,
#: PyTorch 2.11.0+cu128) on an H100 80GB HBM3 at 700 W: 192 and 126
#: outputs natively 6.4-77.7 ms at batch 5 and 8, 256 wide 0.94-1.25 ms.
#: ``tests/test_torch_eraft.py``'s card test re-times it; drop
#: ``WideConv2d`` where the native widths are no slower.
WIDE_OUTPUTS = 256


class WideConv2d(nn.Conv2d):
    """An ``nn.Conv2d`` computed as a convolution to a multiple of
    ``WIDE_OUTPUTS`` outputs whose extra kernels and biases are zeros, the
    extra outputs dropped: the same arithmetic, and the same state-dict
    keys, for the outputs kept. For 3x3 convolutions from 256 channels of
    60x80 maps to 126, 128 or 192 outputs, cuDNN's float32 heuristics pick
    FFT algorithms that take 4-100 ms at batch 5 or 8, where 256 outputs
    take 0.9-1.3 ms. Without autograd the padded weight and bias are made
    once and again only when the parameters change (their version counter
    or their storage): ``load_state_dict`` and ``.to`` make them anew."""

    _wide = None

    def _widened(self):
        pad = (-self.out_channels) % WIDE_OUTPUTS
        return (F.pad(self.weight, (0, 0, 0, 0, 0, 0, 0, pad)),
                F.pad(self.bias, (0, pad)))

    def forward(self, x):
        if torch.is_grad_enabled():
            w, b = self._widened()
        else:
            key = tuple((t._version, t.data_ptr(), t.device, t.dtype)
                        for t in (self.weight, self.bias))
            if self._wide is None or self._wide[0] != key:
                self._wide = (key, *self._widened())
            _, w, b = self._wide
        out = F.conv2d(x, w, b, self.stride, self.padding)
        return out[:, :self.out_channels]


class BasicMotionEncoder(nn.Module):
    """The correlation features and the current flow, encoded to 128
    channels (126 and the flow itself). ``convc2`` and ``conv`` run 256
    wide (``WideConv2d``)."""

    def __init__(self, corr_planes: int):
        super().__init__()
        self.convc1 = nn.Conv2d(corr_planes, 256, 1)
        self.convc2 = WideConv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = WideConv2d(64 + 192, 128 - 2, 3, padding=1)

    def forward(self, flow, corr):
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class SepConvGRU(nn.Module):
    """A ConvGRU run twice, with 1x5 and then 5x1 kernels."""

    def __init__(self, hidden_dim: int, input_dim: int):
        super().__init__()
        c = hidden_dim + input_dim
        for name, k, p in (("1", (1, 5), (0, 2)), ("2", (5, 1), (2, 0))):
            for gate in "zrq":
                setattr(self, f"conv{gate}{name}",
                        nn.Conv2d(c, hidden_dim, k, padding=p))

    def _half(self, h, x, convz, convr, convq):
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(convz(hx))
        r = torch.sigmoid(convr(hx))
        q = torch.tanh(convq(torch.cat([r * h, x], dim=1)))
        return (1 - z) * h + z * q

    def forward(self, h, x):
        h = self._half(h, x, self.convz1, self.convr1, self.convq1)
        return self._half(h, x, self.convz2, self.convr2, self.convq2)


class FlowHead(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden_dim, 2, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class BasicUpdateBlock(nn.Module):
    """One refinement: motion features, the GRU step, the flow update and
    the upsampling mask (scaled by 0.25, as RAFT's)."""

    def __init__(self, corr_planes: int, hidden_dim: int, context_dim: int):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_planes)
        self.gru = SepConvGRU(hidden_dim, 128 + context_dim)
        self.flow_head = FlowHead(hidden_dim, 256)
        self.mask = nn.Sequential(
            nn.Conv2d(hidden_dim, 256, 3, padding=1), nn.ReLU(inplace=True),
            nn.Conv2d(256, 64 * 9, 1))

    def forward(self, net, inp, corr, flow):
        features = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, features], dim=1))
        return net, 0.25 * self.mask(net), self.flow_head(net)


def coords_grid(batch: int, H: int, W: int, device=None):
    """``(batch, 2, H, W)`` pixel coordinates, x first."""
    ys, xs = torch.meshgrid(torch.arange(H, device=device),
                            torch.arange(W, device=device), indexing="ij")
    return torch.stack([xs, ys]).float()[None].repeat(batch, 1, 1, 1)


def correlation_pyramid(fmap1, fmap2, levels: int):
    """All-pairs correlation ``fmap1^T fmap2 / sqrt(D)`` of two ``(B, D, H,
    W)`` maps, shaped ``(B H W, 1, H, W)``, and ``levels - 1`` 2x2 average
    pools of it: the pyramid, finest first."""
    B, D, H, W = fmap1.shape
    corr = torch.bmm(fmap1.reshape(B, D, H * W).transpose(1, 2),
                     fmap2.reshape(B, D, H * W))
    corr = corr.div_(math.sqrt(D)).view(B * H * W, 1, H, W)
    pyramid = [corr]
    for _ in range(levels - 1):
        corr = F.avg_pool2d(corr, 2, stride=2)
        pyramid.append(corr)
    return pyramid


def lookup(pyramid, coords, radius: int):
    """The ``(2r+1)^2`` bilinear samples of every level around ``coords /
    2^l`` (``coords`` ``(B, 2, H, W)``, x first): ``(B, levels (2r+1)^2, H,
    W)``. The offsets are RAFT's ``stack(meshgrid(dy, dx))``: the first
    index of the window moves x, the second y, and channel ``a (2r+1) + b``
    is the sample at ``(x + a - r, y + b - r)``."""
    B, _, H, W = coords.shape
    d = torch.linspace(-radius, radius, 2 * radius + 1,
                       device=coords.device)
    delta = torch.stack(torch.meshgrid(d, d, indexing="ij"), dim=-1)
    delta = delta.view(1, 2 * radius + 1, 2 * radius + 1, 2)
    centroid = coords.permute(0, 2, 3, 1).reshape(B * H * W, 1, 1, 2)
    out = []
    for level, corr in enumerate(pyramid):
        h, w = corr.shape[-2:]
        xy = centroid / 2 ** level + delta
        x, y = xy.split(1, dim=-1)
        grid = torch.cat([2 * x / (w - 1) - 1, 2 * y / (h - 1) - 1], dim=-1)
        out.append(F.grid_sample(corr, grid, align_corners=True)
                   .view(B, H, W, -1))
    return torch.cat(out, dim=-1).permute(0, 3, 1, 2).contiguous()


def upsample_convex(flow, mask):
    """``(B, 2, H, W)`` flow to ``(B, 2, 8H, 8W)``: each fine pixel a
    convex combination (softmax of its 9 ``mask`` weights) of the 3x3
    neighbourhood of ``8 flow`` around its coarse pixel."""
    B, _, H, W = flow.shape
    mask = torch.softmax(mask.view(B, 1, 9, 8, 8, H, W), dim=2)
    up = F.unfold(8 * flow, [3, 3], padding=1).view(B, 2, 9, 1, 1, H, W)
    up = torch.sum(mask * up, dim=2).permute(0, 1, 4, 2, 5, 3)
    return up.reshape(B, 2, 8 * H, 8 * W)


def init_eraft(model: nn.Module, seed: int = 0) -> nn.Module:
    """Draw every weight from one ``torch.Generator`` seeded by ``seed``,
    modules in registration order, as RAFT initialises: the encoders'
    kernels normal with variance 2/fan_out (``kaiming_normal_``,
    ``fan_out``), the update block's uniform in +-1/sqrt(fan_in) (PyTorch's
    default), every bias uniform in +-1/sqrt(fan_in). Batch norms get
    drawn scales, shifts and running statistics, so that their eval
    statistics matter."""
    g = torch.Generator(device="cpu").manual_seed(int(seed))

    def draw(shape, fill):
        t = torch.empty(shape)
        fill(t)
        return t

    encoders = {id(m) for enc in (model.fnet, model.cnet)
                for m in enc.modules()}
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                bound = 1.0 / math.sqrt(fan_in)
                if id(m) in encoders:
                    std = math.sqrt(2.0 / (m.weight.shape[0]
                                           * m.weight[0, 0].numel()))
                    w = draw(m.weight.shape,
                             lambda t: t.normal_(0.0, std, generator=g))
                else:
                    w = draw(m.weight.shape, lambda t: t.uniform_(
                        -bound, bound, generator=g))
                m.weight.copy_(w)
                m.bias.copy_(draw(m.bias.shape, lambda t: t.uniform_(
                    -bound, bound, generator=g)))
            elif isinstance(m, nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(draw(n, lambda t: t.uniform_(
                    0.5, 1.5, generator=g)))
                m.bias.copy_(draw(n, lambda t: t.normal_(
                    0.0, 0.1, generator=g)))
                m.running_mean.copy_(draw(n, lambda t: t.normal_(
                    0.0, 0.1, generator=g)))
                m.running_var.copy_(draw(n, lambda t: t.uniform_(
                    0.5, 1.5, generator=g)))
    return model


class ERAFT(nn.Module):
    """E-RAFT over two ``(B, in_channels, H, W)`` voxel grids, the earlier
    and the later window; H and W multiples of 8, with the coarsest level
    of the correlation pyramid at least 2x2. ``forward(image1, image2) ->
    (flow (B, 2, H, W), flow8 (B, 2, H/8, W/8))``: the displacement in
    pixels over the later window, upsampled and at 1/8 resolution.

    At the defaults (E-RAFT's DSEC setting with 15 bins) it has 5,332,800
    parameters: RAFT's 5.26 M with stems that read 15 channels."""

    #: predicts from pairs of grids (``FlowTrainer.predict_pairs``)
    takes_pairs = True

    def __init__(self, in_channels: int = 15, iters: int = 12,
                 seed: int = 0):
        super().__init__()
        if iters < 1:
            raise ConfigurationError(f"ERAFT needs iters >= 1, got {iters}")
        self.iters = int(iters)
        self.fnet = BasicEncoder(in_channels, FEATURE_DIM, "instance")
        self.cnet = BasicEncoder(in_channels, HIDDEN_DIM + CONTEXT_DIM,
                                 "batch")
        self.update_block = BasicUpdateBlock(
            CORR_LEVELS * (2 * CORR_RADIUS + 1) ** 2, HIDDEN_DIM,
            CONTEXT_DIM)
        init_eraft(self, seed)

    @staticmethod
    def check_size(H: int, W: int):
        """Raise ``ConfigurationError`` unless H and W are multiples of 8
        and the pyramid's coarsest level, ``(H/8, W/8) / 2^(levels-1)``,
        is at least 2x2 (its sampling grid divides by ``side - 1``)."""
        low = 8 * 2 ** (CORR_LEVELS - 1)
        if H % 8 or W % 8 or H // low < 2 or W // low < 2:
            raise ConfigurationError(
                f"ERAFT needs sides that are multiples of 8 and at least "
                f"{2 * low} with {CORR_LEVELS} pyramid levels, got {H}x{W}")

    def encode(self, image1, image2):
        """``(fmap1, fmap2, net, inp)``: both grids' features in one batch,
        the hidden state and the context of the later grid."""
        fmap1, fmap2 = self.fnet(torch.cat([image1, image2])).chunk(2)
        net, inp = self.cnet(image2).split([HIDDEN_DIM, CONTEXT_DIM], dim=1)
        return fmap1, fmap2, torch.tanh(net), torch.relu(inp)

    def correlation(self, fmap1, fmap2):
        return correlation_pyramid(fmap1, fmap2, CORR_LEVELS)

    def forward(self, image1, image2):
        B, _, H, W = image2.shape
        self.check_size(H, W)
        with no_tf32():
            with profiling.span("eraft.encode"):
                fmap1, fmap2, net, inp = self.encode(image1, image2)
            with profiling.span("eraft.corr"):
                pyramid = self.correlation(fmap1, fmap2)
            with profiling.span("eraft.refine"):
                coords0 = coords_grid(B, H // 8, W // 8, image2.device)
                coords1 = coords0
                for _ in range(self.iters):
                    corr = lookup(pyramid, coords1, CORR_RADIUS)
                    net, mask, delta = self.update_block(
                        net, inp, corr, coords1 - coords0)
                    coords1 = coords1 + delta
            with profiling.span("eraft.upsample"):
                flow8 = coords1 - coords0
                flow = upsample_convex(flow8, mask)
        profiling.count("eraft.pairs", B)
        profiling.count("eraft.iterations", B * self.iters)
        return flow, flow8
