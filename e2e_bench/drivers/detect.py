"""Driver: a recording's objects detected by RVT, as ``cli/detect.py``
composes it.

Set-up builds the program's detector from its registry with the network
the configuration names (``model_kwargs``: the architecture key and the
classes; the program holds RVT-B's widths) and loads into it the weights
that the configuration's reference draws from ``--seed`` (RVT's keys,
strictly: a missing, extra or mis-shaped parameter or buffer fails
set-up, as does a parameter count other than the configuration's
``parameters``), writes the recording, opens it as the CLI does
(``MemMapDataset``, ``t_seconds`` windows, stacked histograms with the
configuration's bins and downsampling) and takes the CLI's chunk
fetch from ``_window_source`` with its window-cache limit at 0, so that
it takes the streaming branch and hands each chunk over on the card
(``ChunkFetch.on``). Each step is one chunk of ``chunk`` windows (a
pass's last chunk holds what is left, as in the CLI): the fetch, then
``detect`` window by window at batch 1 from the state the last chunk left,
and the decoded predictions copied to the host. The CLI's file write is
left out. After a pass the recording starts over, cold, from the zero
state. Warm-up runs in set-up, after the cold first chunk, in whole passes:
the rest of the first pass (every chunk shape once), then
``warmup_passes`` more.

A record's ``windows`` counts windows and ``events`` their events, by the
driver's own window bounds.

Span: ``forward`` (from the call into ``detect`` to the predictions on
the host); the chunk fetch is the program's own span ``reconstruct.fetch``.
In the traced run (the harness's spans on) the program's own spans and
counters are turned on too, and each step's record carries
``profiling.take()``'s totals under ``program``; ``close`` restores them.

The check: window ``j`` of a pass is ``[searchsorted(t, t_0 + j T),
searchsorted(t, t_0 + j T + T))`` over the recording's float64 stamps, by
the driver's own count, ``int((t_last - t_0) / T)`` of them a pass; a
dataset whose length or index table differs counts as a mismatch. The
cold first chunk and a seeded share of the measured ones are kept (their
histograms, the state before and after, and the raw predictions) and
worked out again by the configuration's reference: histograms rebuilt
from the raw recording at the derived bounds (compared exactly: counts are
integers), then the network over them from the program's own state at the
chunk's start, with the reference's weights (the ones the program loaded).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from gen.recording import make_recording, raw_events


def _host(state):
    if state is None:
        return None
    return [tuple(t.detach().float().cpu() for t in pair) for pair in state]


def model_kwargs(cfg) -> dict:
    net = cfg["network"]
    return {"architecture": net["model"],
            "num_classes": int(net["num_classes"])}


def window_bounds(path, t_window):
    """Each window's ``(start, end)`` event indices, as ``t_seconds``
    windows are defined, from the recording's own stamps."""
    t = np.load(os.path.join(path, "t.npy"), mmap_mode="r")[:, 0]
    t0 = float(t[0])
    n = max(int((float(t[-1]) - t0) / t_window), 0)
    starts = [t_window * i + t0 for i in range(n)]
    return [(int(np.searchsorted(t, s)),
             int(np.searchsorted(t, s + t_window))) for s in starts]


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.traffic = ctx.cfg, ctx.wl["traffic"]
        self.net = ctx.cfg["network"]
        self.sensor = tuple(ctx.cfg["sensor"])
        self.padded = tuple(ctx.cfg["padded"])
        self.sample_rng = np.random.default_rng([ctx.seed, 1])
        self.samples = []
        self.keep_next = False
        self.t = float(self.traffic["t"])
        self.chunk = int(self.traffic["chunk"])
        self.pos = 0                  # the next chunk's first window
        self.state = None
        self.bound_mismatches = 0
        self.program_spans = None     # the registry's state before ours

    # -- set-up -------------------------------------------------------------
    def setup(self):
        t0 = time.perf_counter()
        from event_utils_tpu_torch._device import to_numpy
        from event_utils_tpu_torch.cli import detect
        from event_utils_tpu_torch.cli import reconstruct as cli
        from event_utils_tpu_torch.data_loaders import MemMapDataset
        from event_utils_tpu_torch.utils import profiling

        self.to_numpy, self.profiling = to_numpy, profiling
        dev = self.ctx.device
        # the network first: a program that cannot build it fails here, in
        # seconds
        self.model = detect.build_model(model_kwargs(self.cfg),
                                        int(self.net["num_bins"]), dev)
        if int(self.net["downsample"]) != detect.DOWNSAMPLE:
            raise ValueError(f"the program halves coordinates by "
                             f"{detect.DOWNSAMPLE}, the configuration by "
                             f"{self.net['downsample']}")
        ref = self.ctx.bench.reference(self.cfg["name"])
        self.params = ref.init_params(self.net, self.ctx.seed)
        self.model.load_state_dict(self.params)
        count = sum(p.numel() for p in self.model.parameters())
        if count != int(self.cfg["parameters"]):
            raise ValueError(f"the program's network has {count} "
                             f"parameters, the configuration "
                             f"{self.cfg['parameters']}")
        t1 = time.perf_counter()
        self.path = make_recording(self.cfg, self.ctx.seed, self.ctx.workdir)
        self.bounds = window_bounds(self.path, self.t)
        t2 = time.perf_counter()
        args = detect.build_parser().parse_args([
            self.path, "--output_dir", os.path.join(self.ctx.workdir, "out"),
            "--t", str(self.t), "--num_bins", str(self.net["num_bins"]),
            "--chunk", str(self.chunk), "--no_window_cache",
            "--device", str(dev)])
        self.dataset = MemMapDataset(
            args.path, voxel_method=cli._voxel_method(args),
            num_bins=args.num_bins, return_events=False,
            return_format="numpy", device=args.device,
            representation="stacked_histogram", downsample=detect.DOWNSAMPLE)
        self.n = len(self.dataset)
        if self.n != len(self.bounds):
            self.bound_mismatches += 1
        self.n = min(self.n, len(self.bounds))
        saved = os.environ.get("EVENT_UTILS_TPU_WINCACHE_LIMIT_MB")
        os.environ["EVENT_UTILS_TPU_WINCACHE_LIMIT_MB"] = "0"
        try:
            self.fetch, _ = cli._window_source(
                self.dataset, args, self.n,
                pad=detect.padder(self.model.input_multiple))
        finally:
            if saved is None:
                del os.environ["EVENT_UTILS_TPU_WINCACHE_LIMIT_MB"]
            else:
                os.environ["EVENT_UTILS_TPU_WINCACHE_LIMIT_MB"] = saved
        self.device = self.dataset.device
        t3 = time.perf_counter()
        self.keep_next = True         # the cold first chunk, for the check
        self.step()
        self._warm_up()
        self.setup_parts = {"program import and network": t1 - t0,
                            "recording": t2 - t1, "dataset": t3 - t2,
                            "first chunk and warm-up":
                                time.perf_counter() - t3}

    def _warm_up(self):
        """The rest of the first pass, then ``warmup_passes`` whole
        passes."""
        while self.pos:
            self.step()
        for _ in range(int(self.traffic["warmup_passes"])):
            self.step()
            while self.pos:
                self.step()

    # -- one chunk ------------------------------------------------------------
    def _program_on(self):
        """Follow the harness's spans: on in the traced run."""
        if self.ctx.spans.enabled and self.program_spans is None:
            self.program_spans = self.profiling.enable_spans(True)
            self.profiling.take()

    def step(self):
        spans = self.ctx.spans
        self._program_on()
        lo = self.pos
        hi = min(lo + self.chunk, self.n)
        for i in range(lo, hi):
            if self.dataset.get_event_indices(i) != self.bounds[i]:
                self.bound_mismatches += 1
        hists, _ = self.fetch.on(self.device, lo, hi)
        start = self.state
        with spans.span("forward"):
            boxes, raw, state = self.model.detect(hists, start)
            boxes = self.to_numpy(boxes)
        if self.keep_next or self.sample_rng.random() < float(
                self.ctx.wl["check"]["fraction"]):
            self.samples.append({
                "windows": (lo, hi), "hists": self.to_numpy(hists),
                "state0": _host(start), "raw": self.to_numpy(raw),
                "state1": _host(state)})
            self.keep_next = False
        self.state = state
        self.pos = hi
        if self.pos >= self.n:
            self.pos, self.state = 0, None
        rec = {"events": sum(b - a for a, b in self.bounds[lo:hi]),
               "windows": hi - lo}
        if self.program_spans is not None:
            taken = self.profiling.take()
            rec["program"] = {"spans": self.profiling.totals(taken.spans),
                              "counts": dict(taken.counts)}
        return rec

    def close(self):
        self.dataset.close()
        self.fetch = None
        if self.program_spans is not None:
            self.profiling.enable_spans(self.program_spans)
            self.profiling.take()
            self.program_spans = None

    # -- the check ------------------------------------------------------------
    def check(self, judge_dtype=torch.float32, control=None):
        """Readings over the kept chunks (the largest of each). With
        ``control`` (a dtype), the program's predictions and states are
        replaced by the reference's own in that precision, as the
        control."""
        ref = self.ctx.bench.reference(self.cfg["name"])
        dev = self.ctx.device
        out = {"window_bounds_mismatches": float(self.bound_mismatches),
               "hist_mismatches": 0.0, "pred_max_rel_diff": 0.0,
               "state_max_rel_diff": 0.0}
        for s in self.samples:
            lo, hi = s["windows"]
            hist = np.stack([ref.stacked_histogram(
                *raw_events(self.path, *self.bounds[i]), self.net,
                self.sensor, self.padded, device=dev).cpu().numpy()
                for i in range(lo, hi)])
            got = s["hists"]
            if got.shape != hist.shape:
                out["hist_mismatches"] = float("inf")
                continue
            out["hist_mismatches"] += float((got != hist).sum())
            raw, state = s["raw"], s["state1"]
            if control is not None:
                raw, state = ref.run(self.params, hist, self.net,
                                     s["state0"], dtype=control, device=dev)
            want, want_state = ref.run(self.params, hist, self.net,
                                       s["state0"], dtype=judge_dtype,
                                       device=dev)
            if raw.shape != want.shape:
                out["pred_max_rel_diff"] = float("inf")
                continue
            out["pred_max_rel_diff"] = max(
                out["pred_max_rel_diff"],
                float(np.abs(raw - want).max()
                      / max(float(np.abs(want).max()), 1e-30)))
            for pair, want_pair in zip(state, want_state):
                for a, b in zip(pair, want_pair):
                    out["state_max_rel_diff"] = max(
                        out["state_max_rel_diff"],
                        float((a - b).abs().max()
                              / max(float(b.abs().max()), 1e-30)))
        out["chunks_checked"] = float(len(self.samples))
        return out
