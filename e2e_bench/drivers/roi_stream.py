"""Driver: a recording streamed in k-event windows into the warm-started
ROI solver, as ``cli/stream_flow.py`` composes it.

Each step is one window: ``NativeWindowedLoader(method='k_events')`` hands
over the next window, its valid events go to ``grid_cmax_batched`` with the
CLI's arguments (``x0`` = the last window's field with invalid ROIs zeroed,
``pyramid=1``, the CLI's defaults unless the cell's traffic sets them), and
the field and mask come back to the host. The CLI's file writes (flow
files, PNGs) are left out. The recording starts over, cold, when it runs
out.

Spans: ``window_fetch`` (the loader), ``solve`` (the solve, ending in the
host read of its result). Each window's bounds are worked out here from
the driver's own count, ``k`` and the recording's length (window ``j`` of a
pass is ``[j k, (j + 1) k)``, ``num_events // k`` of them a pass), and every
window whose loader indices differ, or a pass that ends early or runs
over, is counted as a mismatch. The check keeps the start (the first
window, cold, solved in set-up) and a seeded sample of the measured
windows, and works each out again with the configuration's reference from
the raw recording at the derived bounds, from the same warm start: the
program's field of the window before, so each window is judged from the
program's own start.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gen.recording import make_recording, raw_events


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.traffic = ctx.cfg, ctx.wl["traffic"]
        self.sensor = tuple(ctx.cfg["sensor"])
        self.sample_rng = np.random.default_rng([ctx.seed, 1])
        self.samples = []
        self.keep_next = False
        self.k = int(self.traffic["k"])
        self.per_pass = int(ctx.cfg["num_events"]) // self.k
        self.pos = 0                  # the next window's place in its pass
        self.bound_mismatches = 0

    # -- set-up -------------------------------------------------------------
    def setup(self):
        t0 = time.perf_counter()
        from event_utils_tpu_torch.contrast_max.events_cmax import \
            grid_cmax_batched
        from event_utils_tpu_torch.data_loaders import NativeWindowedLoader

        self.solve_fn = grid_cmax_batched
        t1 = time.perf_counter()
        self.path = make_recording(self.cfg, self.ctx.seed, self.ctx.workdir)
        t2 = time.perf_counter()
        self.loader = NativeWindowedLoader(
            self.path, method="k_events", k=self.k,
            batch_size=1, shuffle=False, relative_time=False)
        self.it = iter(self.loader)
        self.prev = None
        # warm up: the cold first window (kept for the check) and warm ones
        self.keep_next = True
        for _ in range(int(self.traffic.get("warmup_windows", 3))):
            self.step()
        self.setup_parts = {"program import": t1 - t0, "recording": t2 - t1,
                            "loader and warm-up": time.perf_counter() - t2}

    # -- one window -----------------------------------------------------------
    def _next_batch(self):
        try:
            return next(self.it)
        except StopIteration:
            if self.pos != self.per_pass:
                self.bound_mismatches += 1
            self.it = iter(self.loader)
            self.prev = None
            self.pos = 0
            return next(self.it)

    def solve(self, xs, ys, ts, ps, x0):
        t = self.traffic
        params, _rois, f, valid = self.solve_fn(
            xs, ys, ts, ps, roi_size=tuple(t["roi_size"]),
            img_size=self.sensor, min_events=int(t["min_events"]),
            maxiter=int(t["maxiter"]), capacity=None, smooth=None, x0=x0,
            pyramid=1, device=self.ctx.device)
        return (params.cpu().numpy(), f.cpu().numpy(),
                valid.cpu().numpy())

    def step(self):
        spans = self.ctx.spans
        with spans.span("window_fetch"):
            batch = self._next_batch()
            ev = batch["events"][0]
            ev = ev[batch["events_mask"][0] != 0]
        i0, i1 = self.pos * self.k, (self.pos + 1) * self.k
        if (self.pos >= self.per_pass
                or (int(batch["window_idx0"][0]),
                    int(batch["window_idx1"][0])) != (i0, i1)):
            self.bound_mismatches += 1
        self.pos += 1
        n = len(ev)
        if n < int(self.traffic["min_events"]):
            return {"events": 0, "windows": 0}
        xs, ys, ts, ps = (np.ascontiguousarray(ev[:, i], np.float32)
                          for i in range(4))
        x0 = self.prev
        with spans.span("solve"):
            params, f, valid = self.solve(xs, ys, ts, ps, x0)
        self.prev = np.where(valid[:, None], params, 0.0).astype(np.float32)
        if self.keep_next or self.sample_rng.random() < float(
                self.ctx.wl["check"]["fraction"]):
            self.samples.append({
                "window": (i0, i1), "events": np.array(ev),
                "x0": None if x0 is None else x0.copy(),
                "params": params, "f": f, "valid": valid})
            self.keep_next = False
        return {"events": n, "windows": 1}

    def close(self):
        self.loader.close()
        self.it = None

    # -- the check ------------------------------------------------------------
    def check(self, judge_dtype=torch.float32, control=None):
        """Readings over the kept windows (the largest of each). With
        ``control`` (a dtype), the program's answers are replaced by the
        reference's own in that precision, as the control."""
        ref = self.ctx.bench.reference(self.cfg["name"])
        t, dev = self.traffic, self.ctx.device
        roi = tuple(t["roi_size"])
        kw = dict(maxiter=int(t["maxiter"]), min_events=int(t["min_events"]),
                  blur_sigma=float(self.cfg["blur_sigma"]), device=dev)
        out = {"window_bounds_mismatches": float(self.bound_mismatches),
               "events_max_abs_diff": 0.0, "valid_mismatches": 0.0,
               "loss_shortfall_rel": 0.0, "reported_loss_gap_rel": 0.0}
        for s in self.samples:
            x, y, ts, p = raw_events(self.path, *s["window"])
            got = s["events"]
            if got.shape[0] != len(x):
                out["events_max_abs_diff"] = float("inf")
                continue
            raw = np.stack([x, y, ts, p], 1)
            out["events_max_abs_diff"] = max(out["events_max_abs_diff"],
                                             float(np.abs(got - raw).max()))
            params, f, valid = s["params"], s["f"], s["valid"]
            if control is not None:
                params, f, valid = (a.cpu().numpy() for a in ref.solve_rois(
                    x, y, ts, p, self.sensor, roi, s["x0"], dtype=control,
                    **kw))
            _, f_ref, v_ref = (a.cpu().numpy() for a in ref.solve_rois(
                x, y, ts, p, self.sensor, roi, s["x0"], dtype=judge_dtype,
                **kw))
            f_at = ref.roi_losses(x, y, ts, p, self.sensor, roi, params,
                                  blur_sigma=kw["blur_sigma"],
                                  device=dev).cpu().numpy()
            out["valid_mismatches"] = max(out["valid_mismatches"],
                                          float((valid != v_ref).sum()))
            v = v_ref & valid
            if not v.any():
                continue
            scale = np.maximum(np.abs(f_ref[v]), np.median(np.abs(f_ref[v])))
            out["loss_shortfall_rel"] = max(
                out["loss_shortfall_rel"],
                float(((f_at[v] - f_ref[v]) / scale).max()))
            out["reported_loss_gap_rel"] = max(
                out["reported_loss_gap_rel"],
                float((np.abs(f[v] - f_at[v]) / scale).max()))
        out["windows_checked"] = float(len(self.samples))
        return out
