"""Plain reference of the configuration ``e2vid``: rpg_e2vid's E2VID
network (``UNetRecurrent``, Rebecq et al., TPAMI 2019, arXiv:1906.07165;
github.com/uzh-rpg/rpg_e2vid ``model/unet.py``, as ``E2VIDRecurrent``
builds it for the released ``E2VID_lightweight``) and its voxel grid, in
plain PyTorch and NumPy. It imports nothing of the program under test and
takes nothing it computed or built: voxel grids are built again from raw
events; the network's depth and widths come from the configuration's
``network`` (``conv_layers``), its layers are written out here, and its
weights are drawn here from the seed (``init_params``), as a state dict
under rpg_e2vid's own key names (without its ``unetrecurrent.`` prefix),
for the program to load.

The network, as rpg_e2vid's code has it: a 5x5 head (ReLU) whose output
is the last skip; encoders of a stride-2 5x5 conv (ReLU) and a ConvLSTM
(``gates = conv3x3(cat(x, h))`` split ``i, f, o, g``; ``c' = s(f) c +
s(i) tanh(g)``, ``h' = s(o) tanh(c')``); post-activation residual blocks
``relu(x + conv2(relu(conv1(x))))``; decoders that take ``x + skip``
(deepest first), upsample x2 bilinearly (``align_corners=False``) and
apply a 5x5 conv (ReLU); then ``sigmoid(conv1x1(x + head))``. Every
convolution is padded by ``kernel // 2`` on each side, as ``nn.Conv2d``
there.

Departures from rpg_e2vid, each an input or a setting and none a change to
the network:

- the decoder form: ``UpsampleConvLayer`` (bilinear x2, then the 5x5
  conv), rpg_e2vid's default ``use_upsample_conv=True``; its
  transposed-convolution form has the same 10,710,401 parameters and is
  not built here;
- input normalisation: rpg_e2vid's ``EventPreprocessor`` scales the
  non-zero voxels of a grid to zero mean and unit standard deviation. The
  program's voxel path (``BaseVoxelDataset`` with no ``RobustNorm``
  transform, as ``cli/reconstruct.py`` builds it) does not, so neither does
  this reference;
- padding: 180 rows are padded with zeros to 184 below the grid, as the
  program's ``cli/reconstruct.py`` pads (``_pad_to_multiple_hw``);
  rpg_e2vid's ``CropParameters`` pads 2 above and 2 below;
- weights: no checkpoint is committed, so the weights are this file's
  seeded random draw (He-normal kernels, biases uniform in
  +-1/sqrt(fan_in), as ``nn.Conv2d``), loaded into the program;
- the voxel grid: rpg_e2vid's ``events_to_voxel_grid_pytorch`` (5 bins,
  bilinear in time over the window's first and last stamps, polarities
  in {-1, 1} summed into one grid), from float32 timestamps.

``dtype`` is the precision of the network's arithmetic: float32 is the
configuration's (TF32 off), bfloat16 the control's.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F


@contextlib.contextmanager
def no_tf32():
    """Float32 matmuls and convolutions in float32, not TF32, whatever the
    process set."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def voxel_grid(xs, ys, ts, ps, num_bins, sensor, padded, device="cpu"):
    """rpg_e2vid's voxel grid of one window's events, zero-padded below
    and to the right to ``padded``: ``(num_bins, Hp, Wp)`` float32.
    ``ts`` float32 seconds, ``ps`` in {-1, 1}."""
    H, W = sensor
    x = torch.as_tensor(np.asarray(xs), device=device).long()
    y = torch.as_tensor(np.asarray(ys), device=device).long()
    t = torch.as_tensor(np.asarray(ts), dtype=torch.float32, device=device)
    p = torch.as_tensor(np.asarray(ps), dtype=torch.float32, device=device)
    grid = torch.zeros(num_bins * H * W, dtype=torch.float32, device=device)
    delta = t[-1] - t[0]
    delta = torch.where(delta == 0, torch.ones_like(delta), delta)
    tn = (num_bins - 1) * (t - t[0]) / delta
    ti = torch.floor(tn)
    dt = tn - ti
    ti = ti.long()
    pix = x + y * W
    for b, val in ((ti, p * (1.0 - dt)), (ti + 1, p * dt)):
        ok = (b >= 0) & (b < num_bins)
        grid.index_add_(0, (pix + b * (W * H))[ok], val[ok])
    Hp, Wp = padded
    return F.pad(grid.view(num_bins, H, W), (0, Wp - W, 0, Hp - H))


def _conv(params, name, x, stride=1):
    w = params[name + ".weight"]
    return F.conv2d(x, w, params[name + ".bias"], stride, w.shape[-1] // 2)


def forward(params, voxel, net, state=None):
    """One window of the network that ``net`` (the configuration's
    ``network``) names: ``voxel`` (B, C, H, W), ``state`` one ``(h, c)``
    pair an encoder (None: zeros). Returns ``(image (B, 1, H, W),
    state)``."""
    relu = torch.relu
    n = int(net["num_encoders"])
    x = head = relu(_conv(params, "head.conv2d", voxel))
    blocks, states = [], []
    for i in range(n):
        x = relu(_conv(params, f"encoders.{i}.conv.conv2d", x, stride=2))
        if state is None:
            h = c = torch.zeros_like(x)
        else:
            h, c = state[i]
        gates = _conv(params, f"encoders.{i}.recurrent_block.Gates",
                      torch.cat([x, h], 1))
        ig, fg, og, gg = gates.chunk(4, 1)
        c = torch.sigmoid(fg) * c + torch.sigmoid(ig) * torch.tanh(gg)
        h = torch.sigmoid(og) * torch.tanh(c)
        x = h
        blocks.append(h)
        states.append((h, c))
    for j in range(int(net["num_residual_blocks"])):
        r = relu(_conv(params, f"resblocks.{j}.conv1", x))
        x = relu(x + _conv(params, f"resblocks.{j}.conv2", r))
    for j in range(n):
        x = F.interpolate(x + blocks[n - 1 - j], scale_factor=2,
                          mode="bilinear", align_corners=False)
        x = relu(_conv(params, f"decoders.{j}.conv2d", x))
    return torch.sigmoid(_conv(params, "pred.conv2d", x + head)), states


def run(params, voxels, net, state=None, dtype=torch.float32,
        device="cpu"):
    """Windows ``voxels`` (T, C, H, W) one after another from ``state``
    (pairs of tensors, or None), batch 1, in ``dtype``. Returns
    ``(images (T, H, W) float32 numpy, final state as float32 CPU
    tensors)``."""
    cast = {k: v.detach().to(device, dtype) for k, v in params.items()}
    if state is not None:
        state = [tuple(s.to(device, dtype) for s in pair) for pair in state]
    images = []
    with torch.no_grad(), no_tf32():
        for v in torch.as_tensor(np.asarray(voxels)):
            img, state = forward(cast, v[None].to(device, dtype), net, state)
            images.append(img[0, 0].float().cpu().numpy())
    return (np.stack(images),
            [tuple(s.float().cpu() for s in pair) for pair in state])


def conv_layers(net, H=1, W=1):
    """Every convolution of one window at ``(H, W)`` of the network that
    ``net`` (the configuration's ``network``) names: ``(name, in, out,
    kernel, H_out, W_out)``, ``name`` rpg_e2vid's key of its weight and
    bias."""
    base, encoders = int(net["base_num_channels"]), int(net["num_encoders"])
    out = [("head.conv2d", int(net["num_bins"]), base, 5, H, W)]
    for i in range(encoders):
        w, h_, w_ = base * 2 ** (i + 1), H >> (i + 1), W >> (i + 1)
        out.append((f"encoders.{i}.conv.conv2d", w // 2, w, 5, h_, w_))
        out.append((f"encoders.{i}.recurrent_block.Gates", 2 * w, 4 * w, 3,
                    h_, w_))
    deep = base * 2 ** encoders
    for j in range(2 * int(net["num_residual_blocks"])):
        out.append((f"resblocks.{j // 2}.conv{j % 2 + 1}", deep, deep, 3,
                    H >> encoders, W >> encoders))
    for j in range(encoders):
        w = deep >> j
        out.append((f"decoders.{j}.conv2d", w, w // 2, 5,
                    H >> (encoders - 1 - j), W >> (encoders - 1 - j)))
    out.append(("pred.conv2d", base, 1, 1, H, W))
    return out


def param_shapes(net) -> dict:
    """Every parameter's shape under rpg_e2vid's keys."""
    shapes = {}
    for name, cin, cout, k, _, _ in conv_layers(net):
        shapes[name + ".weight"] = (cout, cin, k, k)
        shapes[name + ".bias"] = (cout,)
    return shapes


def num_parameters(net) -> int:
    """10,710,401 at the published settings (FireNet's 10.71 M)."""
    return sum(int(np.prod(s)) for s in param_shapes(net).values())


def init_params(net, seed):
    """This file's weights for the network, drawn from ``seed``: kernels
    normal with variance 2 / fan_in (He's, so that activations keep their
    scale through the ReLUs of a network with no trained weights), biases
    uniform in +-1/sqrt(fan_in). A state dict of float32 CPU tensors."""
    rng = np.random.default_rng([int(seed) % 2 ** 64, 0xE2])
    params = {}
    for name, cin, _, k, _, _ in conv_layers(net):
        fan_in = cin * k * k
        w = rng.standard_normal(param_shapes(net)[name + ".weight"],
                                dtype=np.float32)
        params[name + ".weight"] = torch.from_numpy(
            w * np.float32(np.sqrt(2.0 / fan_in)))
        bound = 1.0 / np.sqrt(fan_in)
        params[name + ".bias"] = torch.from_numpy(rng.uniform(
            -bound, bound, param_shapes(net)[name + ".bias"]
        ).astype(np.float32))
    return params


def flops_per_window(cfg) -> float:
    """The network's operations for one window at the configuration's
    padded size: 2 x the multiply-adds of every convolution at its output
    resolution (40.10 GFLOP at 184x240). Left out: biases, the bilinear
    upsampling, the skip sums and the gates' pointwise work (sigmoid,
    tanh, the cell update), a few MFLOP together."""
    net, (H, W) = cfg["network"], cfg["padded"]
    return float(sum(
        2 * cin * cout * k * k * h * w for _, cin, cout, k, h, w in
        conv_layers(net, H, W)))
