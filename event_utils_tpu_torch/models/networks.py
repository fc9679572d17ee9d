"""The learned models that consume voxel-grid batches: EV-FlowNet and E2VID.

Port of the inference half of ``event_utils_tpu.models.networks`` (the
flax modules) as ``torch.nn.Module``s:

- ``EVFlowNet``  — encoder-decoder optical flow (Zhu et al.);
- ``E2VID``      — recurrent encoder-decoder intensity reconstruction
  (Rebecq et al.) with ConvGRU state.

and, with no flax counterpart, ``UNetRecurrent``: rpg_e2vid's own E2VID
network at its published widths (a 5x5 head, ConvLSTM encoders, summed
skips, symmetric padding), with ``(h, c)`` state a level.

All take ``(B, C, H, W)`` float32 voxel grids (C = 2*num_bins
polarity-split or num_bins combined, what ``BaseVoxelDataset`` emits).

Layout and names. Tensors are NCHW, so flax's channel-last concatenations
and splits run on axis 1. Every module registers its submodules under the
names flax gives them, in flax's creation order (``Conv_0``,
``_Encoder_0``, ``ConvGRU_1``, ...), so a key of a JAX ``params.npz``
names its parameter here directly (``convert.load_params_npz``).

What differs from ``nn.Conv2d`` defaults, on purpose:

- flax ``padding="SAME"`` pads ``(0, 1)`` for a stride-2 3x3 kernel on an
  even input (nothing before, one after), where ``padding=1`` would pad
  ``(1, 1)`` and shift every output by one pixel: ``SameConv`` computes
  flax's padding per axis;
- ``jax.image.resize(..., "bilinear")`` for the x2 upsampling samples at
  half-pixel centres and renormalises at the borders, which is
  ``F.interpolate(mode="bilinear", align_corners=False)`` with no
  antialiasing;
- weights are drawn from an explicit ``torch.Generator`` (flax's default
  ``lecun_normal``: truncated normal of variance 1/fan_in; zero biases).

The forward passes run inside ``_device.no_tf32()``: cuDNN would run f32
convolutions in TF32 (~1e-3 relative) by default, and the reference is
f32. Tolerance class: f32, ~1e-5 of the output's scale against the JAX
package (accumulation order only).

The training losses (``contrast_flow_loss``, ``perceptual_distance``,
``reconstruction_loss``) close the module. ``contrast_flow_loss`` splats
all B elements of a batch in ONE flat scatter (ids offset by ``b*H*W``),
where the JAX package vmaps one splat per element: under
``set_default_impl('pallas')`` that is one flat-kernel launch per loss on
the card, differentiated through the kernel's gather adjoint
(``ops.cuda_scatter._FlatScatter``). The perceptual loss's fixed random
filters are JAX's threefry draws, carried over as data
(``training/data/perceptual_filters.npz``, written by
``scripts/make_train_eval_scenes.py``).
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .._device import no_tf32
from ..errors import ConfigurationError

PERCEPTUAL_FILTERS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "training",
    "data", "perceptual_filters.npz")


def _same_pads(n: int, kernel: int, stride: int):
    """flax/XLA ``SAME`` padding of one axis: (before, after)."""
    total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
    return total // 2, total - total // 2


class SameConv(nn.Module):
    """2-D convolution with flax's ``padding="SAME"`` (``nn.Conv``).

    ``weight`` is OIHW, ``bias`` per output channel. Parameters start
    empty; the owning model draws them (``init_lecun_normal``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3,
                 stride: int = 1):
        super().__init__()
        self.kernel, self.stride = kernel, stride
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(out_channels))

    def forward(self, x):
        return same_conv2d(x, self.weight, self.bias, self.stride)


def same_conv2d(x, weight, bias=None, stride: int = 1):
    """``F.conv2d`` with flax/XLA ``SAME`` padding (OIHW ``weight``)."""
    k = weight.shape[-1]
    top, bottom = _same_pads(x.shape[-2], k, stride)
    left, right = _same_pads(x.shape[-1], k, stride)
    if top == bottom and left == right:
        return F.conv2d(x, weight, bias, stride, (top, left))
    return F.conv2d(F.pad(x, (left, right, top, bottom)), weight, bias,
                    stride)


def init_lecun_normal(model: nn.Module, seed: int = 0) -> nn.Module:
    """Draw every ``SameConv`` of ``model`` as flax's default does:
    kernels from a truncated normal (+-2 sigma) of variance 1/fan_in,
    biases zero. One ``torch.Generator`` seeded by ``seed``, modules in
    registration order. The draws are not flax's (Threefry bits are not
    reproducible in torch); load JAX weights with ``convert`` for parity."""
    g = torch.Generator(device="cpu").manual_seed(int(seed))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, SameConv):
                fan_in = m.weight.shape[1] * m.kernel * m.kernel
                # std of the unit normal truncated at +-2 sigma
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                w = torch.empty(m.weight.shape)
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                      generator=g)
                m.weight.copy_(w)
                m.bias.zero_()
    return model


def _check_divisible(hw, depth, name):
    """Fail loudly on spatial dims the stride-2 pyramid cannot round-trip —
    otherwise the decoder would drop skip connections and return a
    differently-shaped output."""
    H, W = int(hw[0]), int(hw[1])
    d = 2 ** depth
    if H % d or W % d:
        raise ConfigurationError(
            f"{name}: input {H}x{W} not divisible by 2^depth={d}; pad with "
            "utils.util.CropParameters first")


def _upsample2x(x):
    return F.interpolate(x, size=(2 * x.shape[-2], 2 * x.shape[-1]),
                         mode="bilinear", align_corners=False)


class ConvGRU(nn.Module):
    """Convolutional GRU cell (the E2VID recurrent state)."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.features = features
        self.Conv_0 = SameConv(in_channels + features, 2 * features)
        self.Conv_1 = SameConv(in_channels + features, features)

    def forward(self, h, x):
        if h is None:
            h = x.new_zeros((x.shape[0], self.features) + x.shape[2:])
        zr = torch.sigmoid(self.Conv_0(torch.cat([x, h], 1)))
        z, r = zr.chunk(2, 1)
        cand = torch.tanh(self.Conv_1(torch.cat([x, r * h], 1)))
        return (1 - z) * h + z * cand


class _Encoder(nn.Module):
    """Stride-2 conv + ReLU per level; every level's output is a skip."""

    def __init__(self, in_channels: int, features: Sequence[int]):
        super().__init__()
        self.n = len(features)
        for i, f in enumerate(features):
            self.add_module(f"Conv_{i}", SameConv(in_channels, f, stride=2))
            in_channels = f

    def forward(self, x):
        skips = []
        for i in range(self.n):
            x = F.relu(getattr(self, f"Conv_{i}")(x))
            skips.append(x)
        return x, skips


class _ResBlock(nn.Module):
    """Pre-activation residual conv block (E2VID bottleneck stack)."""

    def __init__(self, features: int):
        super().__init__()
        self.Conv_0 = SameConv(features, features)
        self.Conv_1 = SameConv(features, features)

    def forward(self, x):
        h = self.Conv_0(F.relu(x))
        h = self.Conv_1(F.relu(h))
        return x + h


class _Decoder(nn.Module):
    """x2 bilinear upsampling + conv + ReLU per level, each level
    concatenated with the encoder's skip of its size, then one more x2
    upsampling and the output conv.

    ``skip_channels`` are the encoder's level widths, shallowest first.
    The flax module concatenates a skip only when its size matches;
    ``_check_divisible`` admits only inputs where every one matches, so
    the port always concatenates."""

    def __init__(self, in_channels: int, features: Sequence[int],
                 out_channels: int, skip_channels: Sequence[int]):
        super().__init__()
        skips = list(reversed(list(skip_channels)[:-1]))
        self.n = min(len(features), len(skips))
        for i in range(self.n):
            self.add_module(f"Conv_{i}", SameConv(in_channels, features[i]))
            in_channels = features[i] + skips[i]
        self.add_module(f"Conv_{self.n}", SameConv(in_channels, out_channels))

    def forward(self, x, skips):
        for i, skip in zip(range(self.n), reversed(skips[:-1])):
            x = F.relu(getattr(self, f"Conv_{i}")(_upsample2x(x)))
            x = torch.cat([x, skip], 1)
        return getattr(self, f"Conv_{self.n}")(_upsample2x(x))


def _features(base_features: int, depth: int):
    return [base_features * (2 ** i) for i in range(depth)]


class EVFlowNet(nn.Module):
    """Encoder-decoder optical flow from voxel grids.

    Input ``(B, in_channels, H, W)`` (H, W multiples of 2^depth — pad with
    ``utils.util.CropParameters``); output ``(B, 2, H, W)`` flow (u, v) in
    px/s. Submodules: ``_Encoder_0``, ``Conv_0`` (bottleneck),
    ``_Decoder_0``.
    """

    def __init__(self, in_channels: int = 10, base_features: int = 32,
                 depth: int = 3, seed: int = 0):
        super().__init__()
        self.depth = depth
        feats = _features(base_features, depth)
        self._Encoder_0 = _Encoder(in_channels, feats)
        self.Conv_0 = SameConv(feats[-1], feats[-1])
        self._Decoder_0 = _Decoder(
            feats[-1], list(reversed(feats[:-1])) or [base_features], 2,
            feats)
        init_lecun_normal(self, seed)

    def forward(self, voxel):
        _check_divisible(voxel.shape[-2:], self.depth, "EVFlowNet")
        with no_tf32():
            x, skips = self._Encoder_0(voxel)
            x = F.relu(self.Conv_0(x))
            return self._Decoder_0(x, skips) * 10.0  # flow-scale init


class E2VID(nn.Module):
    """Recurrent intensity reconstruction from voxel grids.

    ``forward(voxel, state) -> (image (B, 1, H, W) in [0, 1], state)``;
    ``state=None`` starts a sequence from zeros. ``recurrent_levels`` 1
    keeps one ConvGRU at the bottleneck (state: one tensor; submodules
    ``_Encoder_0``, ``ConvGRU_0``, ``Conv_0``); ``k > 1`` adds a ConvGRU
    after each of the ``k`` deepest encoder levels (state: a ``k``-tuple,
    shallowest first; submodules ``Conv_0..depth-1`` for the encoder,
    ``ConvGRU_0..k-1``, ``Conv_{depth}`` for the bottleneck).
    ``num_res_blocks`` stacks ``_ResBlock_i`` at the bottleneck.
    """

    def __init__(self, in_channels: int = 10, base_features: int = 32,
                 depth: int = 3, recurrent_levels: int = 1,
                 num_res_blocks: int = 0, seed: int = 0):
        super().__init__()
        if not 1 <= recurrent_levels <= depth:
            raise ConfigurationError(
                f"E2VID: recurrent_levels={recurrent_levels} must be "
                f"in [1, depth={depth}]")
        self.depth = depth
        self.recurrent_levels = recurrent_levels
        self.num_res_blocks = num_res_blocks
        feats = self.feats = _features(base_features, depth)
        if recurrent_levels == 1:
            self._Encoder_0 = _Encoder(in_channels, feats)
            self.ConvGRU_0 = ConvGRU(feats[-1], feats[-1])
        else:
            first_rec = depth - recurrent_levels
            ch = in_channels
            for i, f in enumerate(feats):
                self.add_module(f"Conv_{i}", SameConv(ch, f, stride=2))
                if i >= first_rec:
                    self.add_module(f"ConvGRU_{i - first_rec}",
                                    ConvGRU(f, f))
                ch = f
        for i in range(num_res_blocks):
            self.add_module(f"_ResBlock_{i}", _ResBlock(feats[-1]))
        self.bottleneck = f"Conv_{0 if recurrent_levels == 1 else depth}"
        self.add_module(self.bottleneck, SameConv(feats[-1], feats[-1]))
        self._Decoder_0 = _Decoder(
            feats[-1], list(reversed(feats[:-1])) or [base_features], 1,
            feats)
        init_lecun_normal(self, seed)

    def state_shapes(self, batch: int, H: int, W: int):
        """Shapes of the recurrent state for a ``(batch, C, H, W)`` input:
        one shape for ``recurrent_levels`` 1, else a tuple of them."""
        if self.recurrent_levels == 1:
            d = 2 ** self.depth
            return (batch, self.feats[-1], H // d, W // d)
        first_rec = self.depth - self.recurrent_levels
        return tuple((batch, f, H // 2 ** (i + 1), W // 2 ** (i + 1))
                     for i, f in enumerate(self.feats) if i >= first_rec)

    def zero_state(self, batch: int, H: int, W: int, device=None):
        """All-zero initial state (what ``state=None`` starts from)."""
        shapes = self.state_shapes(batch, H, W)
        if self.recurrent_levels == 1:
            return torch.zeros(shapes, device=device)
        return tuple(torch.zeros(s, device=device) for s in shapes)

    def forward(self, voxel, state=None):
        _check_divisible(voxel.shape[-2:], self.depth, "E2VID")
        with no_tf32():
            if self.recurrent_levels == 1:
                x, skips = self._Encoder_0(voxel)
                state = self.ConvGRU_0(state, x)
                bottleneck = state
            else:
                first_rec = self.depth - self.recurrent_levels
                states_in = ((None,) * self.recurrent_levels
                             if state is None else tuple(state))
                x, skips, new_states = voxel, [], []
                for i in range(self.depth):
                    x = F.relu(getattr(self, f"Conv_{i}")(x))
                    if i >= first_rec:
                        j = i - first_rec
                        x = getattr(self, f"ConvGRU_{j}")(states_in[j], x)
                        new_states.append(x)
                    skips.append(x)
                state = tuple(new_states)
                bottleneck = x
            for i in range(self.num_res_blocks):
                bottleneck = getattr(self, f"_ResBlock_{i}")(bottleneck)
            x = F.relu(getattr(self, self.bottleneck)(bottleneck))
            img = torch.sigmoid(self._Decoder_0(x, skips))
        return img, state


# ---------------------------------------------------------------------------
# rpg_e2vid's UNetRecurrent (no flax counterpart)
# ---------------------------------------------------------------------------

class PadConv(nn.Module):
    """2-D convolution padded by ``kernel // 2`` zeros on every side, as
    ``nn.Conv2d(padding=kernel // 2)`` in rpg_e2vid. For a stride-2 5x5
    kernel on an even input that is 2 before and 2 after, where flax's
    ``SAME`` (``SameConv``) pads 1 before and 2 after: the outputs differ
    by a one-pixel shift, so the two are not interchangeable.

    Parameters start empty; ``init_unet_recurrent`` draws them."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int = 1):
        super().__init__()
        self.kernel, self.stride = kernel, stride
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(out_channels))

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride,
                        self.kernel // 2)


class _ConvLayer(nn.Module):
    """rpg_e2vid's ``ConvLayer`` without a norm: ``conv2d``, then ReLU
    unless ``relu=False``."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int = 1, relu: bool = True):
        super().__init__()
        self.relu = relu
        self.conv2d = PadConv(in_channels, out_channels, kernel, stride)

    def forward(self, x):
        x = self.conv2d(x)
        return F.relu(x) if self.relu else x


class ConvLSTM(nn.Module):
    """Convolutional LSTM cell (rpg_e2vid's ``ConvLSTM``, kernel 3; RVT's
    stages take it at kernel 1).

    ``gates = Gates(cat(x, h))`` split into ``i, f, o, g`` in that order;
    ``c' = sigmoid(f) c + sigmoid(i) tanh(g)``, ``h' = sigmoid(o)
    tanh(c')``. ``forward(x, state) -> (h', c')``; ``state=None`` starts
    from zeros."""

    def __init__(self, input_size: int, hidden_size: int, kernel: int = 3):
        super().__init__()
        self.hidden_size = hidden_size
        self.Gates = PadConv(input_size + hidden_size, 4 * hidden_size,
                             kernel)

    def forward(self, x, state=None):
        if state is None:
            z = x.new_zeros((x.shape[0], self.hidden_size) + x.shape[2:])
            state = (z, z)
        h, c = state
        i, f, o, g = self.Gates(torch.cat([x, h], 1)).chunk(4, 1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c


class _RecurrentConvLayer(nn.Module):
    """A stride-2 5x5 ``conv`` + ReLU, then a ``recurrent_block``
    (``ConvLSTM`` of the conv's width): outputs ``h'`` and keeps
    ``(h', c')``."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = _ConvLayer(in_channels, out_channels, 5, stride=2)
        self.recurrent_block = ConvLSTM(out_channels, out_channels)

    def forward(self, x, state):
        state = self.recurrent_block(self.conv(x), state)
        return state[0], state


class _PostActResBlock(nn.Module):
    """rpg_e2vid's ``ResidualBlock`` without a norm, post-activation:
    ``relu(x + conv2(relu(conv1(x))))`` (``_ResBlock`` is
    pre-activation)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = PadConv(channels, channels, 3)
        self.conv2 = PadConv(channels, channels, 3)

    def forward(self, x):
        return F.relu(x + self.conv2(F.relu(self.conv1(x))))


class _UpsampleConvLayer(nn.Module):
    """rpg_e2vid's ``UpsampleConvLayer``: x2 bilinear
    (``align_corners=False``), then a 5x5 ``conv2d`` + ReLU."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv2d = PadConv(in_channels, out_channels, 5)

    def forward(self, x):
        return F.relu(self.conv2d(_upsample2x(x)))


def init_unet_recurrent(model: nn.Module, seed: int = 0) -> nn.Module:
    """Draw every ``PadConv`` of ``model`` from one ``torch.Generator``
    seeded by ``seed``, modules in registration order: kernels from a
    normal of variance 2/fan_in truncated at +-2 sigma (He's, so that
    activations keep their scale through the ReLU stack of a network with
    no trained weights), biases uniform in +-1/sqrt(fan_in) (PyTorch's
    ``nn.Conv2d`` default)."""
    g = torch.Generator(device="cpu").manual_seed(int(seed))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, PadConv):
                fan_in = m.weight.shape[1] * m.kernel * m.kernel
                std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
                w = torch.empty(m.weight.shape)
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                      generator=g)
                m.weight.copy_(w)
                bound = 1.0 / math.sqrt(fan_in)
                b = torch.empty(m.bias.shape)
                b.uniform_(-bound, bound, generator=g)
                m.bias.copy_(b)
    return model


class UNetRecurrent(nn.Module):
    """rpg_e2vid's ``UNetRecurrent`` (Rebecq et al., TPAMI 2019,
    arXiv:1906.07165; ``model/unet.py``) with the settings of its
    released ``E2VID_lightweight``: skips summed, ConvLSTM, upsampling
    decoders, no norm, sigmoid output. At the defaults (5 bins, base 32,
    3 encoders, 2 residual blocks) it has 10,710,401 parameters.

    - ``head``: 5x5 conv ``in_channels -> base`` + ReLU, full resolution;
      its output is the last skip.
    - ``encoders.i``: stride-2 5x5 conv ``base 2^i -> base 2^(i+1)`` +
      ReLU, then a ``ConvLSTM`` of that width.
    - ``resblocks.j``: post-activation 3x3 blocks at ``base
      2^num_encoders``.
    - ``decoders.j``: ``x + skip`` (the encoders' outputs, deepest
      first), x2 bilinear, 5x5 conv halving the width + ReLU.
    - ``pred``: 1x1 conv of ``x + head`` to one channel, then a sigmoid.

    ``forward(voxel, state) -> (image (B, 1, H, W) in [0, 1], state)``;
    ``state`` is one ``(h, c)`` pair a level, shallowest first
    (``state=None`` starts from zeros). Submodules carry rpg_e2vid's
    own names, so its state-dict keys (without the ``unetrecurrent.``
    prefix) name the parameters here. H and W must be multiples of
    ``2^num_encoders``."""

    def __init__(self, in_channels: int = 5, base_num_channels: int = 32,
                 num_encoders: int = 3, num_residual_blocks: int = 2,
                 seed: int = 0):
        super().__init__()
        self.num_encoders = num_encoders
        base = base_num_channels
        self.widths = [base * 2 ** (i + 1) for i in range(num_encoders)]
        self.head = _ConvLayer(in_channels, base, 5)
        self.encoders = nn.ModuleList(
            _RecurrentConvLayer(w // 2, w) for w in self.widths)
        self.resblocks = nn.ModuleList(
            _PostActResBlock(self.widths[-1])
            for _ in range(num_residual_blocks))
        self.decoders = nn.ModuleList(
            _UpsampleConvLayer(w, w // 2) for w in reversed(self.widths))
        self.pred = _ConvLayer(base, 1, 1, relu=False)
        init_unet_recurrent(self, seed)

    def state_shapes(self, batch: int, H: int, W: int):
        """Shapes of the state for a ``(batch, C, H, W)`` input: an
        ``(h, c)`` pair of shapes a level, shallowest first."""
        return tuple(((batch, w, H >> (i + 1), W >> (i + 1)),) * 2
                     for i, w in enumerate(self.widths))

    def zero_state(self, batch: int, H: int, W: int, device=None):
        """All-zero initial state (what ``state=None`` starts from)."""
        return tuple(tuple(torch.zeros(s, device=device) for s in pair)
                     for pair in self.state_shapes(batch, H, W))

    def forward(self, voxel, state=None):
        _check_divisible(voxel.shape[-2:], self.num_encoders,
                         "UNetRecurrent")
        if state is None:
            state = (None,) * self.num_encoders
        with no_tf32():
            x = head = self.head(voxel)
            blocks, states = [], []
            for encoder, s in zip(self.encoders, state):
                x, s = encoder(x, s)
                blocks.append(x)
                states.append(s)
            for block in self.resblocks:
                x = block(x)
            for decoder, skip in zip(self.decoders, reversed(blocks)):
                x = decoder(x + skip)
            img = torch.sigmoid(self.pred(x + head))
        return img, tuple(states)


#: the reconstruction networks by ``model_kwargs["architecture"]``
#: (``training.reconstruction.ReconstructionTrainer``); absent: ``E2VID``
RECONSTRUCTION_MODELS = {"E2VID": E2VID, "UNetRecurrent": UNetRecurrent}


def _build_eraft(**kwargs):
    """``models.eraft.ERAFT(**kwargs)``, its module imported at the first
    build, so that paths which build no E-RAFT never import it."""
    from .eraft import ERAFT
    return ERAFT(**kwargs)


#: the flow networks by ``model_kwargs["architecture"]``
#: (``training.loop.FlowTrainer``), each a callable that builds it;
#: absent: ``EVFlowNet``
FLOW_MODELS = {"EVFlowNet": EVFlowNet, "ERAFT": _build_eraft}


def _build_rvt(**kwargs):
    """``models.rvt.RVT(**kwargs)``, its module imported at the first
    build."""
    from .rvt import RVT
    return RVT(**kwargs)


#: the detection networks by ``model_kwargs["architecture"]``
#: (``build_detector``, ``cli/detect.py``), each a callable that builds it
DETECTION_MODELS = {"RVT": _build_rvt}


def build_detector(model_kwargs: dict, in_channels: int):
    """The detection network ``model_kwargs`` names (``"architecture"``,
    a key of ``DETECTION_MODELS``, and the network's own arguments) over
    ``in_channels`` input channels, in eval mode on the CPU."""
    kwargs = dict(model_kwargs)
    arch = kwargs.pop("architecture", None)
    if arch not in DETECTION_MODELS:
        raise ConfigurationError(
            f"unknown detection architecture {arch!r}; one of "
            f"{sorted(DETECTION_MODELS)}")
    return DETECTION_MODELS[arch](in_channels=in_channels, **kwargs).eval()


# ---------------------------------------------------------------------------
# Training losses
# ---------------------------------------------------------------------------

def _gather_rows(img, x, y):
    """Per-row 4-tap bilinear gather: ``img`` (B, C, H, W) sampled at the
    float coordinates ``x``, ``y`` (B, N) of its row -> (B, C, N). The
    formula of ``ops.scatter.bilinear_gather`` (taps outside the image
    give 0), which samples one image."""
    B, C, H, W = img.shape
    flat = img.reshape(B, C, H * W)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    dx = x - x0
    dy = y - y0

    def tap(oy, ox, wt):
        xx = x0 + ox
        yy = y0 + oy
        valid = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
        pix = (torch.where(valid, yy, 0.0).long() * W
               + torch.where(valid, xx, 0.0).long())
        v = torch.gather(flat, 2, pix[:, None, :].expand(B, C, -1))
        return torch.where(valid[:, None], v, 0.0) * wt[:, None]

    return (tap(0, 0, (1 - dx) * (1 - dy)) + tap(0, 1, dx * (1 - dy))
            + tap(1, 0, (1 - dx) * dy) + tap(1, 1, dx * dy))


def contrast_flow_loss(flow, events, events_mask, sensor_size,
                       blur_sigma: float = 1.0,
                       smoothness_weight: float = 0.5):
    """Self-supervised EV-FlowNet loss: warp each window's raw events by the
    predicted dense flow, maximise the contrast (variance) of the blurred
    image of warped events, plus a total-variation prior on the flow.

    The warp runs with the compensating sign: ``-flow`` through the formula
    of ``transforms.optic_flow.warp_events_flow`` (each event moves by the
    flow at its pixel times ``t - t0``, ``t0`` its row's last valid stamp),
    so the network learns true forward flow, the simulator's convention.
    The IWE of every element is one bilinear splat of ``p * mask`` over the
    warped events inside the frame; all B splats go to ONE
    ``ops.scatter.scatter_add_flat`` into ``B*H*W`` buckets.

    @param flow ``(B, 2, H, W)`` predicted flow
    @param events ``(B, N, 4)`` padded raw events (x, y, t, p)
    @param events_mask ``(B, N)`` validity
    """
    from ..ops.blur import gaussian_blur_image
    from ..ops.scatter import _bilinear_taps, scatter_add_flat

    H, W = sensor_size
    B = flow.shape[0]
    xs, ys, ts, ps = events.unbind(-1)
    m = events_mask != 0
    t0 = torch.where(m.any(1), torch.where(m, ts, -torch.inf).amax(1),
                     0.0)[:, None]
    # padding_mode='zeros' of the reference warp: a zero ring and a
    # shifted, clamped gather
    padded = F.pad(-flow, (1, 1, 1, 1))
    uv = _gather_rows(padded, torch.clamp(xs + 1.0, 0.0, W + 1.0),
                      torch.clamp(ys + 1.0, 0.0, H + 1.0))
    dt = ts - t0
    xw = torch.where(m, xs + uv[:, 0] * dt, xs)
    yw = torch.where(m, ys + uv[:, 1] * dt, ys)
    valid = (xw >= 0) & (xw < W) & (yw >= 0) & (yw < H) & m
    idxs, ws = _bilinear_taps(xw, yw, ps * events_mask, (H, W), valid)
    base = (torch.arange(B, device=flow.device) * (H * W))[:, None, None]
    ids = torch.stack(idxs, 1)                       # (B, 4, N)
    ids = torch.where(ids >= 0, ids + base, -1)
    iwe = scatter_add_flat(ids.reshape(-1), torch.stack(ws, 1).reshape(-1),
                           B * H * W).view(B, H, W)
    iwe = gaussian_blur_image(iwe, blur_sigma)
    contrast = torch.mean(-torch.var(iwe, dim=(1, 2), correction=0))
    tv = (torch.mean(torch.abs(torch.diff(flow, dim=-1)))
          + torch.mean(torch.abs(torch.diff(flow, dim=-2))))
    return contrast + smoothness_weight * tv


def perceptual_filters(levels: int = 3, features: int = 16, seed: int = 0,
                       device=None):
    """The fixed random filters of ``perceptual_distance``: JAX's draws from
    ``jax.random.PRNGKey(seed)``, scaled by ``1/sqrt(9 * in_channels)``,
    read from ``training/data/perceptual_filters.npz``. Only the JAX
    defaults (3 levels of 16 filters from seed 0 over one input channel)
    were carried over; others raise ``ConfigurationError``."""
    if (levels, features, seed) != (3, 16, 0):
        raise ConfigurationError(
            f"perceptual filters carried over from JAX: levels=3, "
            f"features=16, seed=0 only, got {(levels, features, seed)}")
    with np.load(PERCEPTUAL_FILTERS) as z:
        return [torch.as_tensor(z[f"level{i}"], device=device)
                for i in range(levels)]


def _perceptual_pyramid(img, filters):
    """Random-conv feature pyramid (stride-2 ``SAME`` conv + ReLU per level,
    channels unit-normalised as LPIPS does)."""
    feats = []
    x = img
    for w in filters:
        x = F.relu(same_conv2d(x, w, stride=2))
        feats.append(x / (torch.linalg.vector_norm(x, dim=1, keepdim=True)
                          + 1e-8))
    return feats


def perceptual_distance(pred, target, levels: int = 3, features: int = 16,
                        seed: int = 0, filters=None):
    """LPIPS-style distance with fixed random features. Inputs
    ``(B, 1, H, W)`` in [0, 1]; ``filters`` defaults to
    ``perceptual_filters(levels, features, seed)`` (pass them in to read
    the file once)."""
    if filters is None:
        filters = perceptual_filters(levels, features, seed, pred.device)
    with no_tf32():
        fp = _perceptual_pyramid(pred, filters)
        ft = _perceptual_pyramid(target, filters)
    return sum(torch.mean((a - b) ** 2) for a, b in zip(fp, ft)) / len(fp)


def reconstruction_loss(pred, target, lpips_weight: float = 0.0,
                        mse_weight: float = 0.0,
                        filters: Optional[Sequence[torch.Tensor]] = None):
    """E2VID supervision: L1, plus ``mse_weight`` times the squared error
    and ``lpips_weight`` times ``perceptual_distance``."""
    loss = torch.mean(torch.abs(pred - target))
    if mse_weight:
        loss = loss + mse_weight * torch.mean(torch.square(pred - target))
    if lpips_weight:
        loss = loss + lpips_weight * perceptual_distance(pred, target,
                                                         filters=filters)
    return loss
