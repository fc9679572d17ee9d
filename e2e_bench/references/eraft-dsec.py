"""Plain reference of the configuration ``eraft-dsec``: E-RAFT (Gehrig,
Millhäusler, Gehrig and Scaramuzza, "E-RAFT: Dense Optical Flow from Event
Cameras", 3DV 2021, arXiv:2108.10552; github.com/uzh-rpg/E-RAFT
``model/eraft.py`` with RAFT's ``extractor.py``, ``update.py``,
``corr.py`` and ``utils.py``, which it copies from Teed and Deng, ECCV
2020) and its voxel grid, in plain PyTorch and NumPy, float32 with TF32
off. It imports nothing of the program under test and takes nothing it
computed or built: voxel grids are built again from raw events; the
network's widths come from the configuration's ``network``
(``conv_layers``), its layers are written out here as functions of a
state dict, and its weights are drawn here from the seed
(``init_params``), under E-RAFT's own key names, for the program to load.

The network, as E-RAFT's code has it in its ``standard`` mode:

- ``BasicEncoder``: ``relu(norm1(conv1 7x7/2 -> 64))``, then two residual
  blocks at each of 64 (stride 1), 96 and 128 (stride 2), each
  ``relu(x' + relu(norm2(conv2(relu(norm1(conv1(x)))))))`` with ``x'`` the
  input, or ``norm3(downsample.0 1x1/s(x))`` in a strided block; then
  ``conv2`` 1x1 to the output width. ``fnet`` (instance norm without
  affine) runs on ``cat([image1, image2])``, ``cnet`` (batch norm, eval
  statistics) on ``image2``; ``cnet``'s output splits into ``tanh`` of the
  hidden width and ``relu`` of the context width;
- ``CorrBlock``: ``fmap1^T fmap2 / sqrt(D)`` shaped ``(B H W, 1, H, W)``,
  three 2x2 average pools; a lookup samples ``bilinear_sampler``
  (``grid_sample``, ``align_corners=True``, zeros outside) at ``coords /
  2^l + delta``, ``delta = stack(meshgrid(dy, dx), -1)``: the first
  window index moves x. RAFT's order, kept: the weights assume it;
- ``BasicUpdateBlock``: ``BasicMotionEncoder`` (``convc1`` 1x1,
  ``convc2`` 3x3, ``convf1`` 7x7, ``convf2`` 3x3, ``conv`` 3x3 to 126,
  ReLUs, the flow appended), ``SepConvGRU`` (``z, r`` sigmoid, ``q``
  tanh, 1x5 then 5x1), ``FlowHead`` (3x3, ReLU, 3x3 to 2) and the mask
  (3x3, ReLU, 1x1 to 576, times 0.25);
- ``iters`` refinements from ``coords1 = coords0``; the last field
  upsampled by ``upsample_flow`` (softmax over 9 mask weights of the 3x3
  unfold of ``8 flow``).

Departures from E-RAFT, each an input or a setting and none a change to
the network:

- only the last iteration's field is upsampled, as RAFT's ``test_mode``;
  E-RAFT upsamples every iteration's (intermediate predictions, read by
  training only);
- the warm-start mode (the previous pair's flow forward-warped as
  ``flow_init``) is not built: standard mode only;
- input normalisation: E-RAFT's DSEC loader scales a grid's non-zero
  voxels to zero mean and unit standard deviation. The program's voxel
  path (``BaseVoxelDataset`` with no transform, as ``cli/infer_flow.py``
  builds it) does not, so neither does this reference;
- padding: E-RAFT's ``ImagePadder(32)`` pads on the top and left to a
  multiple of 32; at 480x640 it pads nothing, and this reference pads
  nothing (its caller gives sides that are multiples of 8);
- weights: no checkpoint is committed (E-RAFT's ``dsec.tar`` is not in
  the repository), so the weights are this file's seeded draw, RAFT's
  initialisation (encoder kernels normal of variance 2/fan_out, update
  block kernels and every bias uniform in +-1/sqrt(fan_in)), with batch
  norm scales, shifts and running statistics drawn too, so that a norm in
  training mode or left out shows;
- the voxel grid: E-RAFT's DSEC ``VoxelGrid`` with integer pixels
  (bilinear in time over the window's first and last stamps, polarities
  in {-1, 1}), 15 bins, from float32 timestamps, unnormalised.

``dtype`` is the precision of the arithmetic: float32 is the
configuration's (TF32 off), bfloat16 the control's.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

ENCODER_LAYERS = ((64, 1), (96, 2), (128, 2))   # (planes, stride) a layer


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
    """The voxel grid of one window's events, zero-padded below and to the
    right to ``padded``: ``(num_bins, Hp, Wp)`` float32. ``ts`` float32
    seconds, ``ps`` in {-1, 1}."""
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


# -- the layers ---------------------------------------------------------------
def _encoder_convs(prefix, cin, out, H, W):
    """``(name, in, out, (kh, kw), stride, H_out, W_out)`` of one
    ``BasicEncoder`` at input ``(H, W)``."""
    convs = [(prefix + ".conv1", cin, 64, (7, 7), 2, H // 2, W // 2)]
    width, h, w = 64, H // 2, W // 2
    for i, (planes, stride) in enumerate(ENCODER_LAYERS):
        h, w = h // stride, w // stride
        for b in (0, 1):
            p = f"{prefix}.layer{i + 1}.{b}"
            s = stride if b == 0 else 1
            convs.append((p + ".conv1", width if b == 0 else planes, planes,
                          (3, 3), s, h, w))
            convs.append((p + ".conv2", planes, planes, (3, 3), 1, h, w))
            if s != 1:
                convs.append((p + ".downsample.0", width, planes, (1, 1), s,
                              h, w))
        width = planes
    convs.append((prefix + ".conv2", width, out, (1, 1), 1, h, w))
    return convs


def _update_convs(net, h, w):
    hdim, cdim = int(net["hidden_dim"]), int(net["context_dim"])
    planes = int(net["corr_levels"]) * (2 * int(net["corr_radius"]) + 1) ** 2
    e, g = "update_block.encoder.", "update_block.gru."
    convs = [(e + "convc1", planes, 256, (1, 1)), (e + "convc2", 256, 192,
                                                   (3, 3)),
             (e + "convf1", 2, 128, (7, 7)), (e + "convf2", 128, 64, (3, 3)),
             (e + "conv", 256, 126, (3, 3))]
    convs += [(g + f"conv{gate}{half}", hdim + 128 + cdim, hdim, k)
              for half, k in (("1", (1, 5)), ("2", (5, 1))) for gate in "zrq"]
    convs += [("update_block.flow_head.conv1", hdim, 256, (3, 3)),
              ("update_block.flow_head.conv2", 256, 2, (3, 3)),
              ("update_block.mask.0", hdim, 256, (3, 3)),
              ("update_block.mask.2", 256, 576, (1, 1))]
    return [(n, i, o, k, 1, h, w) for n, i, o, k in convs]


def conv_layers(net, H=128, W=128):
    """Every convolution of one pair at ``(H, W)``: ``(name, in, out, (kh,
    kw), stride, H_out, W_out, calls)``, ``calls`` the times a pair runs
    it: twice for ``fnet`` (both grids), once for ``cnet``, ``iters``
    times for the update block."""
    C = int(net["num_bins"])
    hdim, cdim = int(net["hidden_dim"]), int(net["context_dim"])
    out = [c + (2,) for c in _encoder_convs("fnet", C,
                                           int(net["feature_dim"]), H, W)]
    out += [c + (1,) for c in _encoder_convs("cnet", C, hdim + cdim, H, W)]
    out += [c + (int(net["iters"]),) for c in _update_convs(net, H // 8,
                                                             W // 8)]
    return out


def norm_layers(net):
    """``cnet``'s batch norms: ``(name, channels)``; a strided block's
    ``norm3`` is also its ``downsample.1``. ``fnet``'s instance norms have
    no state."""
    out = [("cnet.norm1", 64)]
    for i, (planes, stride) in enumerate(ENCODER_LAYERS):
        for b in (0, 1):
            p = f"cnet.layer{i + 1}.{b}"
            out += [(p + ".norm1", planes), (p + ".norm2", planes)]
            if b == 0 and stride != 1:
                out.append((p + ".norm3", planes))
    return out


def param_shapes(net) -> dict:
    """Every parameter's shape under E-RAFT's keys, each once (a strided
    block's ``norm3`` and not its ``downsample.1``)."""
    shapes = {}
    for name, cin, cout, k, *_ in conv_layers(net):
        shapes[name + ".weight"] = (cout, cin) + tuple(k)
        shapes[name + ".bias"] = (cout,)
    for name, c in norm_layers(net):
        shapes[name + ".weight"] = shapes[name + ".bias"] = (c,)
    return shapes


def num_parameters(net) -> int:
    """5,332,800 at E-RAFT's DSEC setting (RAFT's 5.26 M with two 7x7
    stems that read 15 channels)."""
    return sum(int(np.prod(s)) for s in param_shapes(net).values())


def init_params(net, seed):
    """This file's weights for the network, drawn from ``seed``, as a state
    dict under E-RAFT's keys (each batch norm's buffers included, a
    strided block's ``norm3`` also as ``downsample.1``): encoder kernels
    normal with variance 2/fan_out, update block kernels uniform in
    +-1/sqrt(fan_in), biases uniform in +-1/sqrt(fan_in); batch norm
    scales uniform in [0.5, 1.5], shifts and running means normal of
    standard deviation 0.1, running variances uniform in [0.5, 1.5].
    Float32 CPU tensors."""
    rng = np.random.default_rng([int(seed) % 2 ** 64, 0xEAF])
    params = {}

    def put(name, a):
        params[name] = torch.from_numpy(np.asarray(a, np.float32))

    for name, cin, cout, k, *_ in conv_layers(net):
        fan_in = cin * k[0] * k[1]
        bound = 1.0 / np.sqrt(fan_in)
        shape = (cout, cin) + tuple(k)
        if name.startswith("update_block."):
            put(name + ".weight", rng.uniform(-bound, bound, shape))
        else:
            std = np.sqrt(2.0 / (cout * k[0] * k[1]))
            put(name + ".weight", rng.standard_normal(shape) * std)
        put(name + ".bias", rng.uniform(-bound, bound, cout))
    for name, c in norm_layers(net):
        put(name + ".weight", rng.uniform(0.5, 1.5, c))
        put(name + ".bias", rng.normal(0.0, 0.1, c))
        put(name + ".running_mean", rng.normal(0.0, 0.1, c))
        put(name + ".running_var", rng.uniform(0.5, 1.5, c))
        params[name + ".num_batches_tracked"] = torch.tensor(0)
        if name.endswith(".norm3"):
            alias = name[:-len("norm3")] + "downsample.1"
            for leaf in ("weight", "bias", "running_mean", "running_var",
                         "num_batches_tracked"):
                params[f"{alias}.{leaf}"] = params[f"{name}.{leaf}"]
    return params


# -- the forward pass ---------------------------------------------------------
def _conv(params, name, x, stride=1):
    w = params[name + ".weight"]
    return F.conv2d(x, w, params[name + ".bias"], stride,
                    (w.shape[-2] // 2, w.shape[-1] // 2))


def _norm(params, name, x, kind):
    if kind == "instance":
        return F.instance_norm(x, eps=1e-5)
    return F.batch_norm(x, params[name + ".running_mean"],
                        params[name + ".running_var"],
                        params[name + ".weight"], params[name + ".bias"],
                        training=False, eps=1e-5)


def encoder(params, prefix, x, kind):
    """``BasicEncoder`` ``prefix`` (``fnet``: instance norm; ``cnet``:
    batch norm) on ``x``."""
    relu = torch.relu
    x = relu(_norm(params, prefix + ".norm1",
                   _conv(params, prefix + ".conv1", x, 2), kind))
    for i, (_, stride) in enumerate(ENCODER_LAYERS):
        for b in (0, 1):
            p = f"{prefix}.layer{i + 1}.{b}"
            s = stride if b == 0 else 1
            y = relu(_norm(params, p + ".norm1",
                           _conv(params, p + ".conv1", x, s), kind))
            y = relu(_norm(params, p + ".norm2",
                           _conv(params, p + ".conv2", y), kind))
            if s != 1:
                x = _norm(params, p + ".norm3",
                          _conv(params, p + ".downsample.0", x, s), kind)
            x = relu(x + y)
    return _conv(params, prefix + ".conv2", x)


def corr_pyramid(fmap1, fmap2, levels):
    """RAFT's ``CorrBlock.__init__``: the all-pairs volume and its pools."""
    batch, dim, ht, wd = fmap1.shape
    corr = torch.matmul(fmap1.view(batch, dim, ht * wd).transpose(1, 2),
                        fmap2.view(batch, dim, ht * wd))
    corr = corr / torch.sqrt(torch.tensor(dim).float())
    corr = corr.reshape(batch * ht * wd, 1, ht, wd)
    pyramid = [corr]
    for _ in range(levels - 1):
        corr = F.avg_pool2d(corr, 2, stride=2)
        pyramid.append(corr)
    return pyramid


def bilinear_sampler(img, coords):
    """RAFT's ``bilinear_sampler``: ``grid_sample`` at pixel
    coordinates."""
    H, W = img.shape[-2:]
    xgrid, ygrid = coords.split([1, 1], dim=-1)
    xgrid = 2 * xgrid / (W - 1) - 1
    ygrid = 2 * ygrid / (H - 1) - 1
    grid = torch.cat([xgrid, ygrid], dim=-1)
    return F.grid_sample(img, grid, align_corners=True)


def lookup(pyramid, coords, radius):
    """RAFT's ``CorrBlock.__call__``: ``(B, levels (2r+1)^2, H, W)``."""
    r = radius
    coords = coords.permute(0, 2, 3, 1)
    batch, h1, w1, _ = coords.shape
    out = []
    for i, corr in enumerate(pyramid):
        dx = torch.linspace(-r, r, 2 * r + 1, device=coords.device)
        dy = torch.linspace(-r, r, 2 * r + 1, device=coords.device)
        delta = torch.stack(torch.meshgrid(dy, dx, indexing="ij"), dim=-1)
        centroid = coords.reshape(batch * h1 * w1, 1, 1, 2) / 2 ** i
        xy = centroid + delta.view(1, 2 * r + 1, 2 * r + 1, 2).to(
            coords.dtype)
        out.append(bilinear_sampler(corr, xy).view(batch, h1, w1, -1))
    return torch.cat(out, dim=-1).permute(0, 3, 1, 2).contiguous()


def update_block(params, net_h, inp, corr, flow):
    """``BasicUpdateBlock``: ``(net, 0.25 mask, delta_flow)``."""
    relu, sig = torch.relu, torch.sigmoid
    e, g = "update_block.encoder.", "update_block.gru."
    cor = relu(_conv(params, e + "convc2",
                     relu(_conv(params, e + "convc1", corr))))
    flo = relu(_conv(params, e + "convf2",
                     relu(_conv(params, e + "convf1", flow))))
    motion = torch.cat([relu(_conv(params, e + "conv",
                                   torch.cat([cor, flo], dim=1))), flow],
                       dim=1)
    x = torch.cat([inp, motion], dim=1)
    h = net_h
    for half in "12":
        hx = torch.cat([h, x], dim=1)
        z = sig(_conv(params, g + "convz" + half, hx))
        r = sig(_conv(params, g + "convr" + half, hx))
        q = torch.tanh(_conv(params, g + "convq" + half,
                             torch.cat([r * h, x], dim=1)))
        h = (1 - z) * h + z * q
    delta = _conv(params, "update_block.flow_head.conv2",
                  relu(_conv(params, "update_block.flow_head.conv1", h)))
    mask = _conv(params, "update_block.mask.2",
                 relu(_conv(params, "update_block.mask.0", h)))
    return h, 0.25 * mask, delta


def upsample(flow, mask):
    """RAFT's ``upsample_flow``: ``(N, 2, H, W)`` to ``(N, 2, 8H, 8W)``."""
    N, _, H, W = flow.shape
    mask = torch.softmax(mask.view(N, 1, 9, 8, 8, H, W), dim=2)
    up = F.unfold(8 * flow, [3, 3], padding=1).view(N, 2, 9, 1, 1, H, W)
    up = torch.sum(mask * up, dim=2).permute(0, 1, 4, 2, 5, 3)
    return up.reshape(N, 2, 8 * H, 8 * W)


def coords_grid(batch, ht, wd, device, dtype):
    ys, xs = torch.meshgrid(torch.arange(ht, device=device),
                            torch.arange(wd, device=device), indexing="ij")
    return torch.stack([xs, ys], dim=0).to(dtype)[None].repeat(batch, 1, 1,
                                                               1)


def forward(params, image1, image2, net):
    """One batch of pairs: ``(flow (B, 2, H, W), flow8 (B, 2, H/8,
    W/8))``, the displacement over the later grid ``image2``."""
    hdim, cdim = int(net["hidden_dim"]), int(net["context_dim"])
    fmap1, fmap2 = torch.split(
        encoder(params, "fnet", torch.cat([image1, image2]), "instance"),
        [image1.shape[0], image2.shape[0]])
    pyramid = corr_pyramid(fmap1, fmap2, int(net["corr_levels"]))
    net_h, inp = torch.split(encoder(params, "cnet", image2, "batch"),
                             [hdim, cdim], dim=1)
    net_h, inp = torch.tanh(net_h), torch.relu(inp)
    N, _, H, W = image2.shape
    coords0 = coords_grid(N, H // 8, W // 8, image2.device, image2.dtype)
    coords1 = coords0
    mask = None
    for _ in range(int(net["iters"])):
        corr = lookup(pyramid, coords1, int(net["corr_radius"]))
        net_h, mask, delta = update_block(params, net_h, inp, corr,
                                          coords1 - coords0)
        coords1 = coords1 + delta
    flow8 = coords1 - coords0
    return upsample(flow8, mask), flow8


def run(params, prev, cur, net, dtype=torch.float32, device="cpu",
        block=8):
    """Pairs ``(prev[j], cur[j])`` of ``(T, C, H, W)`` grids, ``block``
    pairs at a time, in ``dtype``. Returns ``(flow (T, 2, H, W), flow8
    (T, 2, H/8, W/8))`` as float32 numpy."""
    cast = {k: v.detach().to(device, dtype) if v.is_floating_point() else v
            for k, v in params.items()}
    prev = torch.as_tensor(np.asarray(prev))
    cur = torch.as_tensor(np.asarray(cur))
    flows, lows = [], []
    with torch.no_grad(), no_tf32():
        for b in range(0, len(cur), block):
            flow, low = forward(cast, prev[b:b + block].to(device, dtype),
                                cur[b:b + block].to(device, dtype), net)
            flows.append(flow.float().cpu().numpy())
            lows.append(low.float().cpu().numpy())
    return np.concatenate(flows), np.concatenate(lows)


def flops_per_pair(cfg) -> float:
    """The network's operations for one pair at the configuration's
    padded size: 2 x the multiply-adds of every convolution at its output
    resolution, each as often as a pair runs it, plus the all-pairs
    correlation product (513.6 GFLOP at 480x640 with 12 iterations).
    Left out: biases, norms, activations, the GRU's pointwise gates, the
    pooling, the lookups' bilinear samples and the upsampling's softmax
    and sums, a few GFLOP together."""
    net, (H, W) = cfg["network"], cfg["padded"]
    convs = sum(2 * cin * cout * k[0] * k[1] * h * w * calls
                for _, cin, cout, k, _, h, w, calls in conv_layers(net, H, W))
    hw = (H // 8) * (W // 8)
    return float(convs + 2 * hw * hw * int(net["feature_dim"]))
