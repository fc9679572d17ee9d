"""Driver: a recording turned into video by E2VID, as ``cli/reconstruct.py``
composes it.

Set-up builds the program's ``ReconstructionTrainer`` with the network the
configuration names (``model_kwargs``: the architecture key and its
widths) and loads into it the weights that the configuration's reference
draws from ``--seed`` (rpg_e2vid's keys, strictly: a missing, extra or
mis-shaped parameter fails set-up, as does a parameter count other than
the configuration's ``parameters``), writes the recording, opens it as
the CLI does (``MemMapDataset``, k_events windows, combined-polarity voxel
grids) and takes the CLI's chunk fetch from ``_window_source`` with its
window-cache limit at 0, so that it takes the streaming branch: every
window's voxel grid is built inside the step that uses it. Each step is
one chunk of ``chunk`` windows (a pass's last chunk holds what is left, as
in the CLI): the fetch, then ``reconstruct`` from the state the last chunk
left, and the images copied to the host. The CLI's PNG writes are left
out. After a pass the recording starts over, cold, from the zero state.
Warm-up runs in set-up, after the cold first chunk, until two successive
slices of ``warmup_slice_s`` complete windows within ``warmup_agree`` of
each other, or for ``warmup_max_s`` at most.

Span: ``forward`` (from the call into ``reconstruct`` to the images on
the host); the chunk fetch is the program's own span
``reconstruct.fetch``. In the traced run (the
harness's spans on) the program's own spans and counters are turned on
too, and each step's record carries ``profiling.take()``'s totals under
``program``; ``close`` restores them.

The check: window ``j`` of a pass is ``[j k, (j + 1) k)`` by the driver's
own count, ``num_events // k`` of them a pass; a dataset whose length or
index table differs counts as a mismatch. The cold first chunk and a
seeded share of the measured ones are kept (their voxel grids, images and
the state before and after) and worked out again by the configuration's
reference: voxel grids rebuilt from the raw recording at the derived
bounds, then the network from the program's own state at the chunk's
start, with the reference's weights (the ones the program loaded).
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
            "base_num_channels": int(net["base_num_channels"]),
            "num_encoders": int(net["num_encoders"]),
            "num_residual_blocks": int(net["num_residual_blocks"])}


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
        self.pos = 0                  # the next chunk's first window
        self.state = None
        self.bound_mismatches = 0
        self.program_spans = None     # the registry's state before ours

    # -- set-up -------------------------------------------------------------
    def setup(self):
        t0 = time.perf_counter()
        from event_utils_tpu_torch._device import to_numpy
        from event_utils_tpu_torch.cli import reconstruct as cli
        from event_utils_tpu_torch.data_loaders import MemMapDataset
        from event_utils_tpu_torch.training.reconstruction import \
            ReconstructionTrainer
        from event_utils_tpu_torch.utils import profiling

        self.to_numpy, self.profiling = to_numpy, profiling
        dev = self.ctx.device
        # the network first: a program that cannot build it fails here, in
        # seconds
        self.trainer = ReconstructionTrainer(
            sensor_size=self.padded, num_bins=self.num_bins,
            combined_channels=True, model_kwargs=model_kwargs(self.cfg),
            seed=self.ctx.seed, device=dev)
        ref = self.ctx.bench.reference(self.cfg["name"])
        self.params = ref.init_params(self.cfg["network"], self.ctx.seed)
        self.trainer.model.load_state_dict(self.params)
        self.trainer.reset_ema()
        count = sum(p.numel() for p in self.trainer.model.parameters())
        if count != int(self.cfg["parameters"]):
            raise ValueError(f"the program's network has {count} "
                             f"parameters, the configuration "
                             f"{self.cfg['parameters']}")
        t1 = time.perf_counter()
        self.path = make_recording(self.cfg, self.ctx.seed, self.ctx.workdir)
        t2 = time.perf_counter()
        args = cli.build_parser().parse_args([
            self.path, "--output_dir", os.path.join(self.ctx.workdir, "out"),
            "--method", "k_events", "--k", str(self.k),
            "--num_bins", str(self.num_bins), "--combined_channels",
            "--chunk", str(self.chunk), "--no_window_cache",
            "--device", str(dev)])
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
            self.fetch, _ = cli._window_source(
                self.dataset, args, self.n, pad=cli._pad_to_multiple_hw)
        finally:
            if saved is None:
                del os.environ["EVENT_UTILS_TPU_WINCACHE_LIMIT_MB"]
            else:
                os.environ["EVENT_UTILS_TPU_WINCACHE_LIMIT_MB"] = saved
        t3 = time.perf_counter()
        self.keep_next = True         # the cold first chunk, for the check
        self.step()
        self.warm_slices = self._warm_up()
        self.setup_parts = {"program import and network": t1 - t0,
                            "recording": t2 - t1, "dataset": t3 - t2,
                            "first chunk and warm-up":
                                time.perf_counter() - t3}

    def _warm_up(self):
        """Windows completed in each warm-up slice."""
        t = self.traffic
        slice_s, agree = float(t["warmup_slice_s"]), float(t["warmup_agree"])
        deadline = time.perf_counter() + float(t["warmup_max_s"])
        slices = []
        while time.perf_counter() < deadline:
            end = min(time.perf_counter() + slice_s, deadline)
            done = 0
            while time.perf_counter() < end:
                done += self.step()["windows"]
            slices.append(done)
            if (len(slices) >= 2 and abs(slices[-1] - slices[-2])
                    <= agree * max(slices[-1], slices[-2])):
                break
        return slices

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
            if self.dataset.get_event_indices(i) != (i * self.k,
                                                     (i + 1) * self.k):
                self.bound_mismatches += 1
        voxels, _ = self.fetch(lo, hi)
        start = self.state
        with spans.span("forward"):
            preds, state = self.trainer.reconstruct(voxels[:, None],
                                                    state=start)
            H, W = self.sensor
            images = self.to_numpy(preds)[:, 0, 0, :H, :W]
        if self.keep_next or self.sample_rng.random() < float(
                self.ctx.wl["check"]["fraction"]):
            self.samples.append({
                "windows": (lo, hi), "voxels": np.array(voxels),
                "state0": _host(start), "images": images,
                "state1": _host(state)})
            self.keep_next = False
        self.state = state
        self.pos = hi
        if self.pos >= self.n:
            self.pos, self.state = 0, None
        rec = {"events": self.k * (hi - lo), "windows": hi - lo}
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
        ``control`` (a dtype), the program's images and states are replaced
        by the reference's own in that precision, as the control."""
        ref = self.ctx.bench.reference(self.cfg["name"])
        dev = self.ctx.device
        net = self.cfg["network"]
        H, W = self.sensor
        out = {"window_bounds_mismatches": float(self.bound_mismatches),
               "voxels_max_rel_diff": 0.0, "images_max_abs_diff": 0.0,
               "state_max_rel_diff": 0.0}
        for s in self.samples:
            lo, hi = s["windows"]
            vox = np.stack([ref.voxel_grid(
                *raw_events(self.path, i * self.k, (i + 1) * self.k),
                self.num_bins, self.sensor, self.padded, device=dev
            ).cpu().numpy() for i in range(lo, hi)])
            got = s["voxels"]
            if got.shape != vox.shape:
                out["voxels_max_rel_diff"] = float("inf")
                continue
            out["voxels_max_rel_diff"] = max(
                out["voxels_max_rel_diff"],
                float(np.abs(got - vox).max()
                      / max(float(np.abs(vox).max()), 1e-30)))
            images, state = s["images"], s["state1"]
            if control is not None:
                images, state = ref.run(self.params, vox, net, s["state0"],
                                        dtype=control, device=dev)
                images = images[:, :H, :W]
            want, want_state = ref.run(self.params, vox, net, s["state0"],
                                       dtype=judge_dtype, device=dev)
            out["images_max_abs_diff"] = max(
                out["images_max_abs_diff"],
                float(np.abs(images - want[:, :H, :W]).max()))
            for pair, want_pair in zip(state, want_state):
                for a, b in zip(pair, want_pair):
                    out["state_max_rel_diff"] = max(
                        out["state_max_rel_diff"],
                        float((a - b).abs().max()
                              / max(float(b.abs().max()), 1e-30)))
        out["chunks_checked"] = float(len(self.samples))
        return out
