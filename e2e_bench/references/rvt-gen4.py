"""Plain reference of the configuration ``rvt-gen4``: RVT-B (Gehrig and
Scaramuzza, "Recurrent Vision Transformers for Object Detection with Event
Cameras", CVPR 2023, arXiv:2212.05598; github.com/uzh-rpg/RVT
``config/model/maxvit_yolox/default.yaml``,
``models/detection/recurrent_backbone/maxvit_rnn.py``,
``models/layers/maxvit/maxvit.py``, ``models/layers/rnn.py``, and YOLOX's
``yolo_pafpn.py``, ``yolo_head.py`` and ``network_blocks.py`` as RVT
carries them) over RVT's stacked histograms
(``data/utils/representations.py``), in plain PyTorch, float32 with TF32
off. It imports nothing of the program under test and takes nothing it
computed or built: histograms are built again from raw events; the
network's widths come from the configuration's ``network`` (``layers``),
its layers are written out here as functions of a state dict, and its
weights are drawn here from the seed (``init_params``), under RVT's key
names, for the program to load.

The network, as RVT's code has it with ``partition_split_32: 2``,
``dim_head: 32``, ``mlp_ratio: 4``, ``mlp_activation: gelu``,
``mlp_gated: False``, ``use_torch_mha: False``, ``dws_conv: False`` and
YOLOX's ``depth: 0.67``:

- four stages (``RNNDetectorStage``): ``ConvDownsampling_Cf2Cl`` (a
  convolution of kernel ``2 (f - 1) + 1``, stride ``f``, padding ``k //
  2``, no bias; ``f`` 4 at the first stage and 2 after; then a LayerNorm,
  channels-last), one ``MaxVitAttentionPairCl`` (block-SA, whose
  ``norm1`` is skipped after the normed downsampling, then grid-SA), each
  partition's ``x + ls1(proj(attn(norm1(x))))`` and ``x +
  ls2(mlp(norm2(x)))`` with ``SelfAttentionCl`` (qkv viewed as ``(heads,
  3 dim_head)``, so each head's q, k and v lie side by side; ``softmax(q
  k^T * dim_head^-0.5) v``, no position bias), then the LSTM over ``cat(x,
  h)`` channels-first, whose ``h`` is the stage's output;
- ``YOLOPAFPN`` over stages 2-4 and ``YOLOXHead`` (width ``int(256 C_4 /
  1024)``, 1x1 stems, two 3x3 units a branch, 1x1 predictions), every
  unit Conv (no bias), BatchNorm (eval statistics, eps 1e-5), SiLU; the
  raw rows ``[reg 4, obj 1, cls]`` level by level, rows first.

Departures from RVT, each a layout or a setting and none a change to the
network's arithmetic:

- the LSTM's weights are laid out as the program's ``ConvLSTM``: key
  ``lstm.Gates``, gates ``i, f, o, g``, where RVT's ``lstm.conv1x1``
  orders them ``f, i, o`` and the cell input last;
- weights: no checkpoint is committed (RVT's Gen4 ``rvt-b.ckpt`` is not in
  the repository), so they are this file's seeded draw, and the
  LayerScales are drawn uniform in [0.5, 1.5] rather than RVT's 1e-5,
  which would leave every attention and MLP branch a 1e-5 share of its
  residual, below any comparison's sight; LayerNorm and batch-norm scales
  and shifts, and batch-norm statistics, are drawn too, so that a norm
  left out or in training mode shows;
- no input normalisation (RVT feeds the clipped counts as they are);
  zero padding below and to the right to multiples of 64 (RVT's
  ``InputPadderFromShape``);
- the histogram's stamps: RVT's are integer microseconds; here they are
  the recording's float32 seconds, as the program packs them, normed over
  ``max(t_last - t_first, 1e-6 s)``;
- the decode (``decode``) is YOLOX's; NMS is not part of the network and
  is not run.

``dtype`` is the precision of the arithmetic: float32 is the
configuration's (TF32 off), bfloat16 the control's.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

MIN_SPAN_S = 1e-6


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


def stacked_histogram(xs, ys, ts, ps, net, sensor, padded, device="cpu"):
    """RVT's ``StackedHistogram`` of one window's events, zero-padded below
    and to the right to ``padded``: ``(2 bins, Hp, Wp)`` float32 counts.
    ``ts`` float32 seconds, ``ps`` in {-1, 1}; coordinates divided by the
    configuration's ``downsample``, counts clipped at ``count_cutoff``."""
    bins, d = int(net["num_bins"]), int(net["downsample"])
    H, W = sensor
    Hd, Wd = -(-H // d), -(-W // d)
    x = torch.as_tensor(np.asarray(xs), device=device).long()
    y = torch.as_tensor(np.asarray(ys), device=device).long()
    t = torch.as_tensor(np.asarray(ts), dtype=torch.float32, device=device)
    p = torch.as_tensor(np.asarray(ps), dtype=torch.float32, device=device)
    keep = (x >= 0) & (x < W) & (y >= 0) & (y < H) & (p != 0)
    span = torch.clamp(t[-1] - t[0], min=MIN_SPAN_S)
    tb = torch.floor((t - t[0]) / span * bins).clamp(max=bins - 1).long()
    ch = (p > 0).long() * bins + tb
    hist = torch.zeros((2 * bins, Hd, Wd), dtype=torch.int64, device=device)
    hist.index_put_((ch[keep], y[keep] // d, x[keep] // d),
                    torch.ones(int(keep.sum()), dtype=torch.int64,
                               device=device), accumulate=True)
    hist = hist.clamp(max=int(net["count_cutoff"])).to(torch.float32)
    Hp, Wp = padded
    return F.pad(hist, (0, Wp - Wd, 0, Hp - Hd))


# -- the layers ---------------------------------------------------------------
def stage_dims(net):
    return [int(net["embed_dim"]) * int(m) for m in net["dim_multiplier"]]


def partition_size(net, H, W):
    m = 32 * int(net["partition_split_32"])
    return H // m, W // m


def _base_conv(name, cin, cout, k, stride, h, w):
    return [("conv", name + ".conv", cin, cout, k, stride, False, h, w),
            ("bn", name + ".bn", cout)]


def _csp(name, cin, cout, n, h, w):
    hid = cout // 2
    out = _base_conv(name + ".conv1", cin, hid, 1, 1, h, w)
    out += _base_conv(name + ".conv2", cin, hid, 1, 1, h, w)
    out += _base_conv(name + ".conv3", 2 * hid, cout, 1, 1, h, w)
    for i in range(n):
        out += _base_conv(f"{name}.m.{i}.conv1", hid, hid, 1, 1, h, w)
        out += _base_conv(f"{name}.m.{i}.conv2", hid, hid, 3, 1, h, w)
    return out


def layers(net, H=384, W=640):
    """Every layer of one window at a padded ``(H, W)`` input, in the order
    of RVT's modules:

    - ``("conv", name, in, out, k, stride, bias, H_out, W_out)``;
    - ``("linear", name, in, out, tokens)``;
    - ``("attn", name, channels, tokens a group, tokens)``: the two
      products of the attention;
    - ``("ln" | "bn" | "ls", name, channels)``."""
    dims = stage_dims(net)
    P = partition_size(net, H, W)
    out, cin, h, w = [], 2 * int(net["num_bins"]), H, W
    for s, C in enumerate(dims):
        f = int(net["stem_patch_size"]) if s == 0 else 2
        h, w = h // f, w // f
        p = f"backbone.stages.{s}."
        out += [("conv", p + "downsample_cf2cl.conv", cin, C,
                 2 * (f - 1) + 1, f, False, h, w),
                ("ln", p + "downsample_cf2cl.norm", C)]
        n = h * w
        for part in ("att_window", "att_grid"):
            q = f"{p}att_blocks.0.{part}."
            if part == "att_grid":
                out.append(("ln", q + "norm1", C))
            out += [("linear", q + "self_attn.qkv", C, 3 * C, n),
                    ("attn", q + "self_attn", C, P[0] * P[1], n),
                    ("linear", q + "self_attn.proj", C, C, n),
                    ("ls", q + "ls1", C), ("ln", q + "norm2", C),
                    ("linear", q + "mlp.net.0.0", C,
                     int(net["mlp_ratio"]) * C, n),
                    ("linear", q + "mlp.net.2", int(net["mlp_ratio"]) * C,
                     C, n),
                    ("ls", q + "ls2", C)]
        out.append(("conv", p + "lstm.Gates", 2 * C, 4 * C, 1, 1, True, h,
                    w))
        cin = C
    c = [dims[s - 1] for s in net["fpn_in_stages"]]
    nb = round(3 * float(net["fpn_depth"]))
    h4, w4, h5, w5, h3, w3 = H // 16, W // 16, H // 32, W // 32, H // 8, \
        W // 8
    out += _base_conv("fpn.lateral_conv0", c[2], c[1], 1, 1, h5, w5)
    out += _csp("fpn.C3_p4", 2 * c[1], c[1], nb, h4, w4)
    out += _base_conv("fpn.reduce_conv1", c[1], c[0], 1, 1, h4, w4)
    out += _csp("fpn.C3_p3", 2 * c[0], c[0], nb, h3, w3)
    out += _base_conv("fpn.bu_conv2", c[0], c[0], 3, 2, h4, w4)
    out += _csp("fpn.C3_n3", 2 * c[0], c[1], nb, h4, w4)
    out += _base_conv("fpn.bu_conv1", c[1], c[1], 3, 2, h5, w5)
    out += _csp("fpn.C3_n4", 2 * c[1], c[2], nb, h5, w5)
    hw = int(net["head_width"])
    sizes = [(h3, w3), (h4, w4), (h5, w5)]
    g = "yolox_head."
    for k, (ci, (hh, ww)) in enumerate(zip(c, sizes)):
        out += _base_conv(f"{g}stems.{k}", ci, hw, 1, 1, hh, ww)
    for branch in ("cls_convs", "reg_convs"):
        for k, (hh, ww) in enumerate(sizes):
            for i in range(2):
                out += _base_conv(f"{g}{branch}.{k}.{i}", hw, hw, 3, 1, hh,
                                  ww)
    for pred, n_out in (("cls_preds", int(net["num_classes"])),
                        ("reg_preds", 4), ("obj_preds", 1)):
        for k, (hh, ww) in enumerate(sizes):
            out.append(("conv", f"{g}{pred}.{k}", hw, n_out, 1, 1, True, hh,
                        ww))
    return out


def param_shapes(net) -> dict:
    """Every parameter's shape under RVT's keys (the LSTM's as the
    program's ``lstm.Gates``)."""
    shapes = {}
    for layer in layers(net):
        kind, name = layer[:2]
        if kind == "conv":
            _, _, cin, cout, k, _, bias, _, _ = layer
            shapes[name + ".weight"] = (cout, cin, k, k)
            if bias:
                shapes[name + ".bias"] = (cout,)
        elif kind == "linear":
            _, _, cin, cout, _ = layer
            shapes[name + ".weight"] = (cout, cin)
            shapes[name + ".bias"] = (cout,)
        elif kind in ("ln", "bn"):
            shapes[name + ".weight"] = shapes[name + ".bias"] = (layer[2],)
        elif kind == "ls":
            shapes[name + ".gamma"] = (layer[2],)
    return shapes


def num_parameters(net) -> int:
    """18,536,856 for RVT-B with 20 input channels and 3 classes: backbone
    12,784,768, PAFPN 3,860,992, head 1,891,096 (RVT's 18.5 M)."""
    return sum(int(np.prod(s)) for s in param_shapes(net).values())


_NO_ACTIVATION_AFTER = ("lstm.Gates", "_preds.")


def init_params(net, seed):
    """This file's weights for the network, drawn from ``seed``, as a state
    dict under RVT's keys: kernels normal, of variance 2/fan_in where
    SiLU or a norm follows and 1/fan_in for the linear layers, the LSTMs'
    gates and the head's predictions; biases uniform in +-1/sqrt(fan_in);
    LayerScales, LayerNorm and batch-norm scales uniform in [0.5, 1.5],
    shifts and running means normal of standard deviation 0.1, running
    variances uniform in [0.5, 1.5]. Float32 CPU tensors."""
    rng = np.random.default_rng([int(seed) % 2 ** 64, 0x52F7])
    params = {}

    def put(name, a):
        params[name] = torch.from_numpy(np.asarray(a, np.float32))

    for layer in layers(net):
        kind, name = layer[:2]
        if kind in ("conv", "linear"):
            if kind == "conv":
                _, _, cin, cout, k, _, bias, _, _ = layer
                shape, fan_in = (cout, cin, k, k), cin * k * k
            else:
                _, _, cin, cout, _ = layer
                shape, fan_in, bias = (cout, cin), cin, True
            gain = 1.0 if (kind == "linear" or any(
                t in name for t in _NO_ACTIVATION_AFTER)) else 2.0
            put(name + ".weight",
                rng.standard_normal(shape) * np.sqrt(gain / fan_in))
            if bias:
                bound = 1.0 / np.sqrt(fan_in)
                put(name + ".bias", rng.uniform(-bound, bound, cout))
        elif kind in ("ln", "bn"):
            c = layer[2]
            put(name + ".weight", rng.uniform(0.5, 1.5, c))
            put(name + ".bias", rng.normal(0.0, 0.1, c))
            if kind == "bn":
                put(name + ".running_mean", rng.normal(0.0, 0.1, c))
                put(name + ".running_var", rng.uniform(0.5, 1.5, c))
                params[name + ".num_batches_tracked"] = torch.tensor(0)
        elif kind == "ls":
            put(name + ".gamma", rng.uniform(0.5, 1.5, layer[2]))
    return params


# -- the forward pass ---------------------------------------------------------
def window_partition(x, P):
    B, H, W, C = x.shape
    x = x.view(B, H // P[0], P[0], W // P[1], P[1], C)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, P[0] * P[1], C)


def window_reverse(windows, P, H, W):
    C = windows.shape[-1]
    x = windows.view(-1, H // P[0], W // P[1], P[0], P[1], C)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, H, W, C)


def grid_partition(x, P):
    B, H, W, C = x.shape
    x = x.view(B, P[0], H // P[0], P[1], W // P[1], C)
    return x.permute(0, 2, 4, 1, 3, 5).contiguous().view(-1, P[0] * P[1], C)


def grid_reverse(windows, P, H, W):
    C = windows.shape[-1]
    x = windows.view(-1, H // P[0], W // P[1], P[0], P[1], C)
    return x.permute(0, 3, 1, 4, 2, 5).contiguous().view(-1, H, W, C)


def _ln(params, name, x):
    w = params[name + ".weight"]
    return F.layer_norm(x, w.shape, w, params[name + ".bias"], 1e-5)


def _linear(params, name, x):
    return F.linear(x, params[name + ".weight"], params[name + ".bias"])


def self_attention(params, name, x, dim_head):
    """``SelfAttentionCl`` over ``(N, T, C)`` token groups."""
    N, T, C = x.shape
    heads = C // dim_head
    qkv = _linear(params, name + ".qkv", x).view(N, T, heads, 3 * dim_head)
    q, k, v = qkv.transpose(1, 2).chunk(3, dim=3)
    attn = (q @ k.transpose(-2, -1)) * dim_head ** -0.5
    out = (attn.softmax(dim=-1) @ v).transpose(1, 2).reshape(N, T, C)
    return _linear(params, name + ".proj", out)


def partition_attention(params, name, x, P, grid, first_norm, net):
    """``PartitionAttentionCl``: channels-last ``(B, H, W, C)``."""
    _, H, W, _ = x.shape
    y = _ln(params, name + ".norm1", x) if first_norm else x
    if grid:
        y = grid_reverse(self_attention(params, name + ".self_attn",
                                        grid_partition(y, P),
                                        int(net["dim_head"])), P, H, W)
    else:
        y = window_reverse(self_attention(params, name + ".self_attn",
                                          window_partition(y, P),
                                          int(net["dim_head"])), P, H, W)
    x = x + y * params[name + ".ls1.gamma"]
    y = F.gelu(_linear(params, name + ".mlp.net.0.0",
                       _ln(params, name + ".norm2", x)))
    return x + _linear(params, name + ".mlp.net.2", y) \
        * params[name + ".ls2.gamma"]


def lstm(params, name, x, state):
    """The stage's 1x1 LSTM, gates ``i, f, o, g``: ``(h', c')``."""
    if state is None:
        state = (torch.zeros_like(x), torch.zeros_like(x))
    h, c = state
    gates = F.conv2d(torch.cat([x, h], 1), params[name + ".weight"],
                     params[name + ".bias"])
    i, f, o, g = gates.chunk(4, 1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def backbone(params, x, state, net):
    """The four stages: ``(features, states)``."""
    H, W = x.shape[-2:]
    P = partition_size(net, H, W)
    features, states = [], []
    for s, C in enumerate(stage_dims(net)):
        f = int(net["stem_patch_size"]) if s == 0 else 2
        p = f"backbone.stages.{s}."
        w = params[p + "downsample_cf2cl.conv.weight"]
        x = F.conv2d(x, w, None, f, w.shape[-1] // 2).permute(0, 2, 3, 1)
        x = _ln(params, p + "downsample_cf2cl.norm", x)
        x = partition_attention(params, p + "att_blocks.0.att_window", x, P,
                                False, False, net)
        x = partition_attention(params, p + "att_blocks.0.att_grid", x, P,
                                True, True, net)
        h, c = lstm(params, p + "lstm.Gates", x.permute(0, 3, 1, 2),
                    None if state is None else state[s])
        features.append(h)
        states.append((h, c))
        x = h
    return features, states


def base_conv(params, name, x, stride=1):
    w = params[name + ".conv.weight"]
    x = F.conv2d(x, w, None, stride, (w.shape[-1] - 1) // 2)
    x = F.batch_norm(x, params[name + ".bn.running_mean"],
                     params[name + ".bn.running_var"],
                     params[name + ".bn.weight"], params[name + ".bn.bias"],
                     training=False, eps=1e-5)
    return F.silu(x)


def csp(params, name, x, n):
    x1 = base_conv(params, name + ".conv1", x)
    for i in range(n):
        x1 = base_conv(params, f"{name}.m.{i}.conv2",
                       base_conv(params, f"{name}.m.{i}.conv1", x1))
    x2 = base_conv(params, name + ".conv2", x)
    return base_conv(params, name + ".conv3", torch.cat([x1, x2], 1))


def pafpn(params, features, net):
    n = round(3 * float(net["fpn_depth"]))
    up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")  # noqa
    x2, x1, x0 = features
    fpn_out0 = base_conv(params, "fpn.lateral_conv0", x0)
    f_out0 = csp(params, "fpn.C3_p4", torch.cat([up(fpn_out0), x1], 1), n)
    fpn_out1 = base_conv(params, "fpn.reduce_conv1", f_out0)
    pan_out2 = csp(params, "fpn.C3_p3", torch.cat([up(fpn_out1), x2], 1), n)
    p_out1 = base_conv(params, "fpn.bu_conv2", pan_out2, 2)
    pan_out1 = csp(params, "fpn.C3_n3", torch.cat([p_out1, fpn_out1], 1), n)
    p_out0 = base_conv(params, "fpn.bu_conv1", pan_out1, 2)
    pan_out0 = csp(params, "fpn.C3_n4", torch.cat([p_out0, fpn_out0], 1), n)
    return pan_out2, pan_out1, pan_out0


def head(params, features):
    """``YOLOXHead``'s raw rows, ``(B, A, 5 + classes)``."""
    g = "yolox_head."
    outs = []
    for k, x in enumerate(features):
        x = base_conv(params, f"{g}stems.{k}", x)
        cls = base_conv(params, f"{g}cls_convs.{k}.1",
                        base_conv(params, f"{g}cls_convs.{k}.0", x))
        reg = base_conv(params, f"{g}reg_convs.{k}.1",
                        base_conv(params, f"{g}reg_convs.{k}.0", x))

        def pred(name, t):
            return F.conv2d(t, params[f"{g}{name}.{k}.weight"],
                            params[f"{g}{name}.{k}.bias"])
        out = torch.cat([pred("reg_preds", reg), pred("obj_preds", reg),
                         pred("cls_preds", cls)], 1)
        outs.append(out.flatten(start_dim=2))
    return torch.cat(outs, dim=2).permute(0, 2, 1)


def forward(params, x, state, net):
    """One window batch ``(B, 2 bins, H, W)`` from ``state`` (a stage's
    ``(h, c)`` each, or None): ``(raw (B, A, 5 + classes), state)``."""
    features, state = backbone(params, x, state, net)
    feats = pafpn(params, [features[s - 1] for s in net["fpn_in_stages"]],
                  net)
    return head(params, feats), state


def decode(raw, H, W, strides=(8, 16, 32)):
    """YOLOX's ``decode_outputs`` of raw rows at an ``(H, W)`` input."""
    grids, mult = [], []
    for s in strides:
        yv, xv = torch.meshgrid(torch.arange(H // s), torch.arange(W // s),
                                indexing="ij")
        grids.append(torch.stack((xv, yv), 2).view(-1, 2))
        mult.append(torch.full((grids[-1].shape[0], 1), float(s)))
    grid = torch.cat(grids).to(raw.device, raw.dtype)
    stride = torch.cat(mult).to(raw.device, raw.dtype)
    return torch.cat([(raw[..., :2] + grid) * stride,
                      torch.exp(raw[..., 2:4]) * stride,
                      torch.sigmoid(raw[..., 4:])], dim=-1)


def run(params, hists, net, state0=None, dtype=torch.float32,
        device="cpu"):
    """Windows ``hists`` ``(T, C, H, W)`` one at a time from ``state0``, the
    state carried, in ``dtype``. Returns ``(raw (T, A, 5 + classes) float32
    numpy, state)``, ``state`` a stage's ``(h, c)`` each as float32 CPU
    tensors."""
    cast = {k: v.detach().to(device, dtype) if v.is_floating_point() else v
            for k, v in params.items()}
    hists = torch.as_tensor(np.asarray(hists))
    state = None if state0 is None else [
        tuple(torch.as_tensor(t).to(device, dtype) for t in pair)
        for pair in state0]
    raws = []
    with torch.no_grad(), no_tf32():
        for j in range(len(hists)):
            raw, state = forward(cast, hists[j:j + 1].to(device, dtype),
                                 state, net)
            raws.append(raw.float().cpu().numpy())
    return np.concatenate(raws), [tuple(t.float().cpu() for t in pair)
                                  for pair in state]


def flops_per_window(cfg) -> float:
    """The network's operations for one window at the configuration's
    padded size: 2 x the multiply-adds of every convolution (the LSTMs'
    gates among them) and linear layer at its output resolution, and of
    the attention's two products (``q k^T`` and the weighted sum of ``v``,
    ``2 tokens P C`` multiply-adds a partition). Left out: biases, norms,
    activations, softmax, the LSTMs' pointwise gates, upsampling and the
    decode, well under a GFLOP together."""
    total = 0
    H, W = cfg["padded"]
    for layer in layers(cfg["network"], H, W):
        kind = layer[0]
        if kind == "conv":
            _, _, cin, cout, k, _, _, h, w = layer
            total += 2 * cin * cout * k * k * h * w
        elif kind == "linear":
            _, _, cin, cout, n = layer
            total += 2 * cin * cout * n
        elif kind == "attn":
            _, _, c, group, n = layer
            total += 2 * 2 * n * group * c
    return float(total)
