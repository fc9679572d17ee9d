"""RVT: a recurrent vision transformer that detects objects in event
streams.

Gehrig and Scaramuzza, "Recurrent Vision Transformers for Object Detection
with Event Cameras", CVPR 2023 (arXiv:2212.05598; github.com/uzh-rpg/RVT
``config/model/maxvit_yolox/default.yaml``,
``models/detection/recurrent_backbone/maxvit_rnn.py``,
``models/layers/maxvit/maxvit.py`` and YOLOX's ``yolo_pafpn.py`` and
``yolo_head.py``), RVT-B: embedding width 64, one MaxViT pair a stage.
Submodules carry RVT's own names (``backbone.stages.0.downsample_cf2cl``,
``att_blocks.0.att_window.self_attn.qkv``, ``ls1.gamma``,
``mlp.net.0.0``, ``fpn.C3_p4.m.0.conv2.bn``, ``yolox_head.cls_preds.2``,
...), so its state-dict keys name the parameters here, except the LSTM's:
a stage's LSTM is the port's ``networks.ConvLSTM`` at kernel 1
(``lstm.Gates``, gates in the order ``i, f, o, g``, where RVT's
``lstm.conv1x1`` orders them ``f, i, o`` and then the cell input: the same
cell, another layout of the same weights).

The forward pass of one ``(B, 2 bins, H, W)`` stacked histogram, H and W
multiples of 64, float32 with TF32 off (``_device.no_tf32``):

- four stages at strides 4, 8, 16 and 32 and widths 64, 128, 256 and 512.
  A stage downsamples with an overlapping convolution (7x7 stride 4 at
  the first, 3x3 stride 2 after; no bias), then a LayerNorm over the
  channels, channels-last from there; then block-SA, attention within
  windows of ``P`` adjacent tokens, and grid-SA, attention among the
  ``P`` tokens spaced ``(H_s / P_h, W_s / P_w)`` apart over the whole map,
  each ``x + ls1(attn(norm1(x)))`` then ``x + ls2(mlp(norm2(x)))``; the
  block-SA's ``norm1`` is left out, as RVT leaves it out after the
  downsampling's norm. ``P = (H / 64, W / 64)``: RVT's
  ``partition_split_32: 2``, the stride-32 map split in two along each
  axis. Attention has ``C / 32`` heads of 32, a qkv projection whose
  output holds each head's q, k and v side by side (RVT's
  ``SelfAttentionCl``), softmax of ``q k^T / sqrt(32)`` and no position
  bias, composed of batched float32 matrix products (no fused attention
  kernel, whose float32 path may compute in TF32); the MLP is
  ``Linear(C, 4C)``, exact GELU, ``Linear(4C, C)``. Last, channels-first
  again, the stage's 1x1 ConvLSTM, whose ``h`` is the stage's output;
- YOLOX's PAFPN over the stages of strides 8, 16 and 32 (depth 0.67: two
  bottlenecks a CSP layer, no shortcut; Conv-BatchNorm-SiLU units; nearest
  x2 upsampling);
- YOLOX's decoupled head at strides 8, 16 and 32, 128 wide: a 1x1 stem,
  two 3x3 units for the classes and two for the boxes, and 1x1
  predictions of the classes, the box and the objectness.

``forward`` gives the raw predictions, ``(B, A, 5 + classes)`` with ``A``
the anchors of the three levels (level by level, rows first) and each
row ``[t_x, t_y, t_w, t_h, objectness, classes...]`` before the exp and
sigmoids; ``decode`` turns them into boxes and scores as YOLOX's
``decode_outputs``: ``xy = (t_xy + grid) stride``, ``wh = exp(t_wh)
stride``, sigmoids on the rest. Non-maximum suppression is left to the
caller.

``detect`` runs each window through ``step``: on the card, without
gradients, the batch-1 forward pass is captured as a CUDA graph at the
first window of a shape, the state passed as tensors, and replayed from
then on, so that a window costs the host one replay and not the issue of
~440 operations.

Spans: ``rvt.attn`` (each partition's normed attention and its residual,
both partitions, every stage), ``rvt.mlp``, ``rvt.lstm``, ``rvt.neck`` and
``rvt.head`` (the eager forward pass), ``rvt.replay`` (a replayed step);
counters ``rvt.windows`` (windows through the network), ``rvt.resets``
(windows started from the zero state) and ``rvt.graph_captures`` (steps
captured).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .._device import no_tf32
from ..errors import ConfigurationError
from ..utils import profiling
from .networks import ConvLSTM

#: RVT-B: the first stage's width, each stage's multiple of it, the
#: attention heads' width and the MLP's expansion
EMBED_DIM, DIM_MULTIPLIER, DIM_HEAD, MLP_RATIO = 64, (1, 2, 4, 8), 32, 4
#: RVT's ``partition_split_32``: the stride-32 map holds this many
#: partitions along each axis
PARTITION_SPLIT = 2
#: YOLOX's depth multiple of the PAFPN (``round(3 depth)`` bottlenecks a
#: CSP layer) and the head's width (``int(256 C_4 / 1024)``)
FPN_DEPTH, HEAD_WIDTH = 0.67, 128
#: the first stage's patch size; each later stage halves the map
STEM_PATCH = 4
#: the stages the PAFPN reads (1-based) and the head's strides
FPN_STAGES, HEAD_STRIDES = (2, 3, 4), (8, 16, 32)


def partition_size(H: int, W: int) -> Tuple[int, int]:
    """Tokens a partition holds along each axis for an ``(H, W)`` input:
    ``(H, W) / (32 PARTITION_SPLIT)``, the same at every stage. Raises
    ``ConfigurationError`` unless both sides are multiples of it."""
    m = 32 * PARTITION_SPLIT
    if H % m or W % m or H < m or W < m:
        raise ConfigurationError(
            f"RVT needs sides that are multiples of {m}, got {H}x{W}")
    return H // m, W // m


def window_partition(x, P):
    """``(B, H, W, C)`` -> ``(B H W / (P_h P_w), P_h P_w, C)``: windows of
    adjacent tokens."""
    B, H, W, C = x.shape
    x = x.view(B, H // P[0], P[0], W // P[1], P[1], C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, P[0] * P[1], C)


def window_reverse(windows, P, H: int, W: int):
    C = windows.shape[-1]
    x = windows.view(-1, H // P[0], W // P[1], P[0], P[1], C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, H, W, C)


def grid_partition(x, P):
    """``(B, H, W, C)`` -> groups of ``P_h P_w`` tokens spaced ``(H /
    P_h, W / P_w)`` apart."""
    B, H, W, C = x.shape
    x = x.view(B, P[0], H // P[0], P[1], W // P[1], C)
    return x.permute(0, 2, 4, 1, 3, 5).reshape(-1, P[0] * P[1], C)


def grid_reverse(windows, P, H: int, W: int):
    C = windows.shape[-1]
    x = windows.view(-1, H // P[0], W // P[1], P[0], P[1], C)
    return x.permute(0, 3, 1, 4, 2, 5).reshape(-1, H, W, C)


class SelfAttentionCl(nn.Module):
    """Multi-head self-attention over ``(N, T, C)`` token groups. The qkv
    projection's output holds, head after head, the head's q, k and v."""

    def __init__(self, dim: int):
        super().__init__()
        self.num_heads = dim // DIM_HEAD
        self.scale = DIM_HEAD ** -0.5
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        N, T, _ = x.shape
        q, k, v = (self.qkv(x).view(N, T, self.num_heads, 3 * DIM_HEAD)
                   .transpose(1, 2).chunk(3, dim=3))
        attn = torch.softmax((q @ k.transpose(-2, -1)) * self.scale, dim=-1)
        return self.proj((attn @ v).transpose(1, 2).reshape(N, T, -1))


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * self.gamma


class MLP(nn.Module):
    """``Linear(C, 4C)``, exact GELU, ``Linear(4C, C)``, under RVT's
    names (``net.0.0`` and ``net.2``; ``net.1`` is its dropout)."""

    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.Sequential(
            nn.Sequential(nn.Linear(dim, MLP_RATIO * dim), nn.GELU()),
            nn.Identity(), nn.Linear(MLP_RATIO * dim, dim))

    def forward(self, x):
        return self.net(x)


class PartitionAttentionCl(nn.Module):
    """One partition's attention and MLP, channels-last, each a residual
    scaled by its LayerScale. ``grid`` picks grid-SA, else block-SA;
    ``skip_first_norm`` leaves ``norm1`` out."""

    def __init__(self, dim: int, grid: bool, skip_first_norm: bool):
        super().__init__()
        self.grid = grid
        self.norm1 = (nn.Identity() if skip_first_norm
                      else nn.LayerNorm(dim, eps=1e-5))
        self.self_attn = SelfAttentionCl(dim)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = MLP(dim)
        self.ls2 = LayerScale(dim)

    def forward(self, x, P):
        _, H, W, _ = x.shape
        part, back = ((grid_partition, grid_reverse) if self.grid
                      else (window_partition, window_reverse))
        with profiling.span("rvt.attn"):
            y = back(self.self_attn(part(self.norm1(x), P)), P, H, W)
            x = x + self.ls1(y)
        with profiling.span("rvt.mlp"):
            return x + self.ls2(self.mlp(self.norm2(x)))


class MaxVitAttentionPairCl(nn.Module):
    """Block-SA, then grid-SA."""

    def __init__(self, dim: int, skip_first_norm: bool):
        super().__init__()
        self.att_window = PartitionAttentionCl(dim, False, skip_first_norm)
        self.att_grid = PartitionAttentionCl(dim, True, False)

    def forward(self, x, P):
        return self.att_grid(self.att_window(x, P), P)


class ConvDownsampling_Cf2Cl(nn.Module):
    """An overlapping convolution (kernel ``2 (factor - 1) + 1``, no
    bias), channels-first in and channels-last out, then a LayerNorm."""

    def __init__(self, dim_in: int, dim_out: int, factor: int):
        super().__init__()
        k = 2 * (factor - 1) + 1
        self.conv = nn.Conv2d(dim_in, dim_out, k, stride=factor,
                              padding=k // 2, bias=False)
        self.norm = nn.LayerNorm(dim_out, eps=1e-5)

    def forward(self, x):
        return self.norm(self.conv(x).permute(0, 2, 3, 1))


class RNNDetectorStage(nn.Module):
    """Downsampling, one MaxViT pair, then the 1x1 ConvLSTM:
    ``forward(x (B, C_in, H, W), state) -> (h, (h, c))``."""

    def __init__(self, dim_in: int, dim: int, factor: int):
        super().__init__()
        self.downsample_cf2cl = ConvDownsampling_Cf2Cl(dim_in, dim, factor)
        # the downsampling's output is normed: the first block-SA skips
        # its own norm, as RVT's stage does
        self.att_blocks = nn.ModuleList([MaxVitAttentionPairCl(dim, True)])
        self.lstm = ConvLSTM(dim, dim, kernel=1)
        # the gates' PadConv starts empty: give it nn.Conv2d's default
        nn.Conv2d.reset_parameters(self.lstm.Gates)

    def forward(self, x, state, P):
        x = self.downsample_cf2cl(x)
        for block in self.att_blocks:
            x = block(x, P)
        with profiling.span("rvt.lstm"):
            state = self.lstm(x.permute(0, 3, 1, 2), state)
        return state[0], state


class RNNDetector(nn.Module):
    """RVT's recurrent backbone: four stages; returns every stage's
    output and state."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.stage_dims = [EMBED_DIM * m for m in DIM_MULTIPLIER]
        stages, dim_in = [], in_channels
        for i, dim in enumerate(self.stage_dims):
            stages.append(RNNDetectorStage(dim_in, dim,
                                           STEM_PATCH if i == 0 else 2))
            dim_in = dim
        self.stages = nn.ModuleList(stages)

    def forward(self, x, state, P):
        features, states = [], []
        for stage, s in zip(self.stages, state):
            x, s = stage(x, s, P)
            features.append(x)
            states.append(s)
        return features, tuple(states)


class BaseConv(nn.Module):
    """YOLOX's unit: a convolution with no bias, padded ``(k - 1) // 2``,
    a batch norm (eval statistics) and SiLU."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride=stride,
                              padding=(k - 1) // 2, bias=False)
        self.bn = nn.BatchNorm2d(cout)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    """A 1x1 then a 3x3 unit at one width, with no shortcut."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv1 = BaseConv(dim, dim, 1)
        self.conv2 = BaseConv(dim, dim, 3)

    def forward(self, x):
        return self.conv2(self.conv1(x))


class CSPLayer(nn.Module):
    """YOLOX's CSP layer: two 1x1 branches of half the output width, the
    first through ``n`` bottlenecks, joined by a 1x1 unit."""

    def __init__(self, cin: int, cout: int, n: int):
        super().__init__()
        hidden = cout // 2
        self.conv1 = BaseConv(cin, hidden, 1)
        self.conv2 = BaseConv(cin, hidden, 1)
        self.conv3 = BaseConv(2 * hidden, cout, 1)
        self.m = nn.Sequential(*[Bottleneck(hidden) for _ in range(n)])

    def forward(self, x):
        return self.conv3(torch.cat([self.m(self.conv1(x)),
                                     self.conv2(x)], dim=1))


def _upsample(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


class YOLOPAFPN(nn.Module):
    """YOLOX's PAFPN over three maps of widths ``c = (c0, c1, c2)``,
    finest first: top-down, then bottom-up; outputs of widths ``c``."""

    def __init__(self, c: Sequence[int]):
        super().__init__()
        n = round(3 * FPN_DEPTH)
        self.lateral_conv0 = BaseConv(c[2], c[1], 1)
        self.C3_p4 = CSPLayer(2 * c[1], c[1], n)
        self.reduce_conv1 = BaseConv(c[1], c[0], 1)
        self.C3_p3 = CSPLayer(2 * c[0], c[0], n)
        self.bu_conv2 = BaseConv(c[0], c[0], 3, 2)
        self.C3_n3 = CSPLayer(2 * c[0], c[1], n)
        self.bu_conv1 = BaseConv(c[1], c[1], 3, 2)
        self.C3_n4 = CSPLayer(2 * c[1], c[2], n)

    def forward(self, features):
        x2, x1, x0 = features
        fpn_out0 = self.lateral_conv0(x0)
        f_out0 = self.C3_p4(torch.cat([_upsample(fpn_out0), x1], 1))
        fpn_out1 = self.reduce_conv1(f_out0)
        pan_out2 = self.C3_p3(torch.cat([_upsample(fpn_out1), x2], 1))
        pan_out1 = self.C3_n3(torch.cat([self.bu_conv2(pan_out2),
                                         fpn_out1], 1))
        pan_out0 = self.C3_n4(torch.cat([self.bu_conv1(pan_out1),
                                         fpn_out0], 1))
        return pan_out2, pan_out1, pan_out0


class YOLOXHead(nn.Module):
    """YOLOX's decoupled head, ``HEAD_WIDTH`` wide at every level; returns
    the raw ``(B, A, 5 + classes)`` rows, level by level."""

    def __init__(self, num_classes: int, c: Sequence[int]):
        super().__init__()
        w = HEAD_WIDTH
        self.stems = nn.ModuleList(BaseConv(ci, w, 1) for ci in c)
        self.cls_convs = nn.ModuleList(
            nn.Sequential(BaseConv(w, w, 3), BaseConv(w, w, 3)) for _ in c)
        self.reg_convs = nn.ModuleList(
            nn.Sequential(BaseConv(w, w, 3), BaseConv(w, w, 3)) for _ in c)
        self.cls_preds = nn.ModuleList(nn.Conv2d(w, num_classes, 1)
                                       for _ in c)
        self.reg_preds = nn.ModuleList(nn.Conv2d(w, 4, 1) for _ in c)
        self.obj_preds = nn.ModuleList(nn.Conv2d(w, 1, 1) for _ in c)

    def forward(self, features):
        outputs = []
        for k, x in enumerate(features):
            x = self.stems[k](x)
            reg = self.reg_convs[k](x)
            out = torch.cat([self.reg_preds[k](reg), self.obj_preds[k](reg),
                             self.cls_preds[k](self.cls_convs[k](x))], 1)
            outputs.append(out.flatten(2))
        return torch.cat(outputs, 2).permute(0, 2, 1)


class CudaStepGraphs:
    """Capture and replay of one step with ``torch.cuda.CUDAGraph``."""

    @staticmethod
    def engages(x) -> bool:
        return x.device.type == "cuda" and not torch.is_grad_enabled()

    @staticmethod
    def capture(run):
        """``(replay, run's outputs)``: ``run`` once eagerly on a side
        stream (PyTorch's rule before a capture), then captured; each
        ``replay()`` writes the outputs anew."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = run()
        return graph.replay, out


class RVT(nn.Module):
    """RVT-B with YOLOX's PAFPN and head (``YoloXDetector``'s ``backbone``,
    ``fpn`` and ``yolox_head``) over ``(B, in_channels, H, W)`` stacked
    histograms, H and W multiples of 64. ``forward(x, state) -> (raw (B,
    A, 5 + num_classes), state)``, ``state`` a stage's ``(h, c)`` each
    (``None`` starts from zeros). At 20 input channels and 3 classes it
    has 18,536,856 parameters, at PyTorch's default initialisation
    (LayerScale at ones) until weights are loaded
    (``convert.load_params_npz``)."""

    def __init__(self, in_channels: int = 20, num_classes: int = 3):
        super().__init__()
        self.num_classes = int(num_classes)
        self.backbone = RNNDetector(in_channels)
        dims = [self.backbone.stage_dims[s - 1] for s in FPN_STAGES]
        self.fpn = YOLOPAFPN(dims)
        self.yolox_head = YOLOXHead(self.num_classes, dims)
        self._grids = {}
        self._steps = {}

    #: sides of the input must be multiples of this
    input_multiple = 32 * PARTITION_SPLIT
    #: how ``step`` captures and replays a window's forward pass
    step_graphs = CudaStepGraphs

    def _apply(self, fn, *args, **kwargs):
        # moved or cast parameters are new tensors: captured steps would
        # read the old ones
        self._steps = {}
        return super()._apply(fn, *args, **kwargs)

    def forward(self, x, state=None):
        P = partition_size(*x.shape[-2:])
        if state is None:
            state = (None,) * len(self.backbone.stages)
            profiling.count("rvt.resets", x.shape[0])
        with no_tf32():
            features, state = self.backbone(x, state, P)
            with profiling.span("rvt.neck"):
                features = self.fpn([features[s - 1] for s in FPN_STAGES])
            with profiling.span("rvt.head"):
                raw = self.yolox_head(features)
        profiling.count("rvt.windows", x.shape[0])
        return raw, state

    def _grid(self, H: int, W: int, device):
        """``(grid (A, 2), stride (A, 1))`` of the anchors at an ``(H, W)``
        input, x first, level by level, rows first."""
        key = (H, W, str(device))
        if key not in self._grids:
            grids, strides = [], []
            for s in HEAD_STRIDES:
                ys, xs = torch.meshgrid(torch.arange(H // s, device=device),
                                        torch.arange(W // s, device=device),
                                        indexing="ij")
                grids.append(torch.stack([xs, ys], -1).view(-1, 2))
                strides.append(torch.full((grids[-1].shape[0], 1), float(s),
                                          device=device))
            self._grids[key] = (torch.cat(grids).float(), torch.cat(strides))
        return self._grids[key]

    def decode(self, raw, H: int, W: int):
        """YOLOX's ``decode_outputs`` of the raw rows of an ``(H, W)``
        input: ``[x, y, w, h]`` in input pixels (box centre and size),
        the objectness and the class scores."""
        grid, stride = self._grid(H, W, raw.device)
        return torch.cat([(raw[..., :2] + grid) * stride,
                          torch.exp(raw[..., 2:4]) * stride,
                          torch.sigmoid(raw[..., 4:])], dim=-1)

    def zero_state(self, x):
        """Each stage's ``(h, c)`` at zero for the input ``x``."""
        B, _, H, W = x.shape
        state = []
        for i, dim in enumerate(self.backbone.stage_dims):
            z = x.new_zeros((B, dim, H >> (2 + i), W >> (2 + i)))
            state.append((z, z))
        return state

    def step(self, x, state=None):
        """``forward(x, state)`` where ``step_graphs`` engages (on the card,
        without gradients) replayed from a graph captured at the first
        step of ``x``'s shape, the state passed as tensors (zeros for
        ``None``); elsewhere ``forward`` itself. A replay counts as
        ``forward`` does and is the span ``rvt.replay``; a capture counts
        ``rvt.graph_captures`` and records none of ``forward``'s spans and
        counts."""
        if not self.step_graphs.engages(x):
            return self(x, state)
        if state is None:
            profiling.count("rvt.resets", x.shape[0])
            state = self.zero_state(x)
        inputs = [x] + [t for hc in state for t in hc]
        key = (tuple(x.shape), x.device, self.training)
        if key not in self._steps:
            self._steps[key] = self._capture(inputs)
        static, replay, outputs = self._steps[key]
        with profiling.span("rvt.replay"):
            for s, a in zip(static, inputs):
                s.copy_(a)
            replay()
            raw, *flat = (o.clone() for o in outputs)
        profiling.count("rvt.windows", x.shape[0])
        return raw, list(zip(flat[0::2], flat[1::2]))

    def _capture(self, inputs):
        """``(static inputs, replay, outputs)`` of one captured step."""
        static = [a.clone() for a in inputs]

        def run():
            raw, state = self(static[0], list(zip(static[1::2],
                                                  static[2::2])))
            return [raw] + [t for hc in state for t in hc]

        was = profiling.enable_spans(False)
        try:
            replay, outputs = self.step_graphs.capture(run)
        finally:
            profiling.enable_spans(was)
        profiling.count("rvt.graph_captures")
        return static, replay, outputs

    @torch.no_grad()
    def detect(self, windows, state=None):
        """Windows ``(T, C, H, W)`` one at a time, at batch 1, the state
        carried from each to the next (``step``): ``(boxes (T, A, 5 +
        classes), raw (T, A, 5 + classes), state)``, ``boxes`` the decoded
        ``raw``."""
        raws = []
        for j in range(windows.shape[0]):
            raw, state = self.step(windows[j:j + 1], state)
            raws.append(raw)
        raw = torch.cat(raws)
        return self.decode(raw, *windows.shape[-2:]), raw, state
