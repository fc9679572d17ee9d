"""Driver: a recording turned into dense optical flow by E-RAFT, as
``cli/infer_flow.py`` composes it.

Set-up builds the program's ``FlowTrainer`` with the network the
configuration names (``model_kwargs``: the architecture key and its
iterations; the program holds E-RAFT's widths) and loads into it the
weights that the configuration's reference draws from ``--seed`` (from
the configuration's widths, under E-RAFT's keys, strictly:
a missing, extra or mis-shaped parameter or buffer fails set-up, as does a
parameter count other than the configuration's ``parameters``), writes
the recording, opens it as the CLI does (``MemMapDataset``, k_events
windows, combined-polarity voxel grids) and takes the CLI's chunk fetch
from ``_window_source`` with its window-cache limit at 0, so that it
takes the streaming branch, behind the CLI's ``PairFetch``: every
window's grid is built inside the step that first uses it, once a pass.
Each step is one chunk of ``chunk`` pairs (a pass's last chunk holds what
is left, as in the CLI): the fetch of its new windows, ``predict_pairs``
on the pairs ``(j, j + 1)``, and the fields (upsampled and 1/8) copied to
the host. The CLI's file writes are left out. After a pass the recording
starts over, cold: the first chunk fetches all of its windows again.
Warm-up runs in set-up, after the cold first chunk, in whole passes: the
rest of the first pass (every chunk shape once: ``chunk`` pairs and the
last chunk's rest), then ``warmup_passes`` more. A step is a chunk, so a
warm-up by slices of time would end only where two slices happened to
hold the same mix of chunks.

A record's ``windows`` counts pairs, and ``events`` the later windows'
events: a pass completes ``num_events // k - 1`` pairs.

Span: ``forward`` (from the call into ``predict_pairs`` to the fields on
the host); the chunk fetch is the program's own span
``reconstruct.fetch``. In the traced run (the harness's spans on) the
program's own spans and counters are turned on too, and each step's
record carries ``profiling.take()``'s totals under ``program``; ``close``
restores them.

The check: window ``j`` of a pass is ``[j k, (j + 1) k)`` by the driver's
own count, ``num_events // k`` of them a pass; a dataset whose length or
index table differs counts as a mismatch. The cold first chunk and a
seeded share of the measured ones are kept (their grids, upsampled and
1/8 fields) and worked out again by the configuration's reference: the
grids rebuilt from the raw recording at the derived bounds, then the
network on the chunk's pairs of them, with the reference's weights (the
ones the program loaded).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from gen.recording import make_recording, raw_events


def model_kwargs(cfg) -> dict:
    net = cfg["network"]
    return {"architecture": net["model"], "iters": int(net["iters"])}


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.traffic = ctx.cfg, ctx.wl["traffic"]
        self.sensor = tuple(ctx.cfg["sensor"])
        self.padded = tuple(ctx.cfg["padded"])
        self.num_bins = int(ctx.cfg["network"]["num_bins"])
        self.sample_rng = np.random.default_rng([ctx.seed, 1])
        self.samples = []
        self.keep_next = False
        self.k = int(self.traffic["k"])
        self.chunk = int(self.traffic["chunk"])
        self.per_pass = int(ctx.cfg["num_events"]) // self.k
        self.pos = 0                  # the next chunk's first pair
        self.bound_mismatches = 0
        self.program_spans = None     # the registry's state before ours

    # -- set-up -------------------------------------------------------------
    def setup(self):
        t0 = time.perf_counter()
        from event_utils_tpu_torch._device import to_numpy
        from event_utils_tpu_torch.cli import infer_flow
        from event_utils_tpu_torch.cli import reconstruct as cli
        from event_utils_tpu_torch.data_loaders import MemMapDataset
        from event_utils_tpu_torch.training.loop import FlowTrainer
        from event_utils_tpu_torch.utils import profiling

        self.to_numpy, self.profiling = to_numpy, profiling
        dev = self.ctx.device
        # the network first: a program that cannot build it fails here, in
        # seconds
        self.trainer = FlowTrainer(
            sensor_size=self.padded, num_bins=self.num_bins,
            combined_channels=True, model_kwargs=model_kwargs(self.cfg),
            seed=self.ctx.seed, device=dev)
        ref = self.ctx.bench.reference(self.cfg["name"])
        self.params = ref.init_params(self.cfg["network"], self.ctx.seed)
        self.trainer.model.load_state_dict(self.params)
        count = sum(p.numel() for p in self.trainer.model.parameters())
        if count != int(self.cfg["parameters"]):
            raise ValueError(f"the program's network has {count} "
                             f"parameters, the configuration "
                             f"{self.cfg['parameters']}")
        t1 = time.perf_counter()
        self.path = make_recording(self.cfg, self.ctx.seed, self.ctx.workdir)
        t2 = time.perf_counter()
        args = infer_flow.build_parser().parse_args([
            self.path, "--output_dir", os.path.join(self.ctx.workdir, "out"),
            "--method", "k_events", "--k", str(self.k),
            "--num_bins", str(self.num_bins), "--combined_channels",
            "--batch_size", str(self.chunk), "--no_window_cache",
            "--architecture", "ERAFT", "--iters",
            str(self.cfg["network"]["iters"]), "--device", str(dev)])
        self.dataset = MemMapDataset(
            args.path, voxel_method=cli._voxel_method(args),
            num_bins=args.num_bins,
            combined_voxel_channels=args.combined_channels,
            return_events=False, return_format="numpy", device=args.device)
        self.n = len(self.dataset)
        if self.n != self.per_pass:
            self.bound_mismatches += 1
        saved = os.environ.get("EVENT_UTILS_TPU_WINCACHE_LIMIT_MB")
        os.environ["EVENT_UTILS_TPU_WINCACHE_LIMIT_MB"] = "0"
        try:
            fetch, _ = cli._window_source(
                self.dataset, args, self.n, pad=cli._pad_to_multiple_hw)
        finally:
            if saved is None:
                del os.environ["EVENT_UTILS_TPU_WINCACHE_LIMIT_MB"]
            else:
                os.environ["EVENT_UTILS_TPU_WINCACHE_LIMIT_MB"] = saved
        self.pairs = infer_flow.PairFetch(fetch, self.trainer.device)
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
        hi = min(lo + self.chunk, self.n - 1)
        for i in range(lo, hi + 1):
            if self.dataset.get_event_indices(i) != (i * self.k,
                                                     (i + 1) * self.k):
                self.bound_mismatches += 1
        grids, _ = self.pairs(lo, hi)
        with spans.span("forward"):
            flow, flow8 = self.trainer.predict_pairs(grids[:-1], grids[1:])
            H, W = self.sensor
            flow = self.to_numpy(flow)[:, :, :H, :W]
            flow8 = self.to_numpy(flow8)
        if self.keep_next or self.sample_rng.random() < float(
                self.ctx.wl["check"]["fraction"]):
            self.samples.append({"pairs": (lo, hi),
                                 "grids": self.to_numpy(grids),
                                 "flow": flow, "flow8": flow8})
            self.keep_next = False
        self.pos = hi if hi < self.n - 1 else 0
        rec = {"events": self.k * (hi - lo), "windows": hi - lo}
        if self.program_spans is not None:
            taken = self.profiling.take()
            rec["program"] = {"spans": self.profiling.totals(taken.spans),
                              "counts": dict(taken.counts)}
        return rec

    def close(self):
        self.dataset.close()
        self.pairs = None
        if self.program_spans is not None:
            self.profiling.enable_spans(self.program_spans)
            self.profiling.take()
            self.program_spans = None

    # -- the check ------------------------------------------------------------
    def check(self, judge_dtype=torch.float32, control=None):
        """Readings over the kept chunks (the largest of each). With
        ``control`` (a dtype), the program's fields are replaced by the
        reference's own in that precision, as the control."""
        ref = self.ctx.bench.reference(self.cfg["name"])
        dev = self.ctx.device
        net = self.cfg["network"]
        H, W = self.sensor
        out = {"window_bounds_mismatches": float(self.bound_mismatches),
               "voxels_max_rel_diff": 0.0, "flow_max_abs_diff": 0.0,
               "flow8_max_rel_diff": 0.0}
        for s in self.samples:
            lo, hi = s["pairs"]
            vox = np.stack([ref.voxel_grid(
                *raw_events(self.path, i * self.k, (i + 1) * self.k),
                self.num_bins, self.sensor, self.padded, device=dev
            ).cpu().numpy() for i in range(lo, hi + 1)])
            got = s["grids"]
            if got.shape != vox.shape:
                out["voxels_max_rel_diff"] = float("inf")
                continue
            out["voxels_max_rel_diff"] = max(
                out["voxels_max_rel_diff"],
                float(np.abs(got - vox).max()
                      / max(float(np.abs(vox).max()), 1e-30)))
            flow, flow8 = s["flow"], s["flow8"]
            if control is not None:
                flow, flow8 = ref.run(self.params, vox[:-1], vox[1:], net,
                                      dtype=control, device=dev)
                flow = flow[:, :, :H, :W]
            want, want8 = ref.run(self.params, vox[:-1], vox[1:], net,
                                  dtype=judge_dtype, device=dev)
            out["flow_max_abs_diff"] = max(
                out["flow_max_abs_diff"],
                float(np.abs(flow - want[:, :, :H, :W]).max()))
            out["flow8_max_rel_diff"] = max(
                out["flow8_max_rel_diff"],
                float(np.abs(flow8 - want8).max()
                      / max(float(np.abs(want8).max()), 1e-30)))
        out["chunks_checked"] = float(len(self.samples))
        return out
