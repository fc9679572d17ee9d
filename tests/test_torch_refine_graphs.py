"""The ROI solvers' GD refine through ``RefineGraphs`` on the CPU.

The refine of ``make_roi_solve_one`` keeps one body, run eagerly or captured
as a CUDA graph and replayed. On the CPU it runs eagerly and must equal the
loop written out below bit for bit (warm, cold, trust-clamped, unclamped,
with and without the adaptive lifespan). The rule that decides when a graph
is captured and replayed is held here with a fake backend that engages on
the CPU: its capture runs the body, its replay runs it again into the
captured outputs and, like a real graph's replay, leaves the wrappers'
launch counts as they were. Card-only checks (no synchronisation in a
replay, graph against eager answers, launch counts on the card) are in
``tests/test_torch_cuda.py``.
"""

import math

import numpy as np
import pytest
import torch

from event_utils_tpu_torch.contrast_max import events_cmax as pc
from event_utils_tpu_torch.models.objectives import (sos_objective,
                                                     variance_objective)
from event_utils_tpu_torch.models.warps import linvel_warp
from event_utils_tpu_torch.ops import cuda_scatter as cs
from event_utils_tpu_torch.utils import profiling
from event_utils_tpu_torch.utils.event_util import lifespan_mask

SENSOR = (24, 32)
ROI = (8, 8)          # 3 x 4 = 12 ROIs
R = 12
MAXITER = 4
GD_LR = 4.0
PATCH_LAUNCH = "bilinear_patches_scatter:direct"
FUSED_LAUNCH = "patch_variance_vg"


def scene(seed=0, n=4000, flow=(10.0, 5.0)):
    """Points moving at a planted flow over the small sensor."""
    g = np.random.default_rng(seed)
    H, W = SENSOR
    px, py = g.uniform(2, W - 14, 30), g.uniform(2, H - 8, 30)
    pol = g.choice([-1.0, 1.0], 30)
    idx = g.integers(0, 30, n)
    ts = np.sort(g.uniform(0, 1.0, n))
    xs = px[idx] + flow[0] * ts + g.normal(0, 0.1, n)
    ys = py[idx] + flow[1] * ts + g.normal(0, 0.1, n)
    return tuple(a.astype(np.float32) for a in (xs, ys, ts, pol[idx]))


def batches(seed=0, capacity=None):
    bx, by, bt, bp, bm, org, _ = pc.bucket_events_by_roi(
        *scene(seed), SENSOR, ROI, capacity=capacity, device="cpu")
    return bx, by, bt, bp, bm, org.to(torch.float32)


def warm_start(seed=1):
    g = np.random.default_rng(seed)
    return torch.as_tensor(g.normal(0, 3, (R, 2)) + [10.0, 5.0],
                           dtype=torch.float32)


def loop_refine(obj, ev, x0, trust=None, maxiter=MAXITER):
    """The GD refine as the solver ran it before the graphs, written out:
    the lifespan mask, the normalised descent with momentum 0.8, cosine
    learning rate, trust clamp and best-iterate tracking, and the answer's
    loss under the full masks."""
    ex, ey, et, ep, emask, origin = ev
    loss = pc._roi_patch_loss(linvel_warp(), obj, SENSOR, ROI, 1.0)
    refine_mask = emask
    if obj.adaptive_lifespan:
        refine_mask = lifespan_mask(et, x0, obj.pixel_crossings,
                                    minimum_events=obj.minimum_events,
                                    base_mask=emask, drop_last=False)
        enough = refine_mask.sum(-1) >= torch.clamp(
            emask.sum(-1), max=float(obj.minimum_events))
        refine_mask = torch.where(enough[:, None], refine_mask, emask)

    def f(p, m=refine_mask):
        return loss(p, ex, ey, et, ep, m, origin)

    with torch.no_grad():
        p, m = x0, torch.zeros_like(x0)
        best_p, best_v = x0, f(x0)
        for i in range(maxiter):
            with torch.enable_grad():
                q = p.detach().requires_grad_(True)
                v = f(q)
                (g,) = torch.autograd.grad(v.sum(), q)
            v = v.detach()
            better = v < best_v
            best_p = torch.where(better[:, None], p, best_p)
            best_v = torch.where(better, v, best_v)
            g = g / (torch.linalg.vector_norm(g, dim=-1, keepdim=True)
                     + 1e-12)
            m = 0.8 * m + g
            lr = GD_LR * 0.5 * (1 + math.cos(math.pi * i / maxiter))
            p = p - lr * m
            if trust is not None:
                p = x0 + torch.minimum(torch.maximum(p - x0, -trust), trust)
        v = f(p)
        better = v < best_v
        best_p = torch.where(better[:, None], p, best_p)
        return best_p, f(best_p, emask)


def solver(obj=None, maxiter=MAXITER, **kw):
    obj = variance_objective() if obj is None else obj
    return pc.make_roi_solve_one(linvel_warp(), obj, SENSOR, ROI, 1.0,
                                 maxiter, "gd", GD_LR, **kw)


class FakeGraphs:
    """A capture/replay backend that engages on every device: capture runs
    the body once, replay runs it again into the captured outputs and then
    puts the launch counts back and records no span, as a graph's replay
    runs no Python."""

    def __init__(self):
        self.warm_ups = self.captures = self.replays = 0

    def engages(self, device):
        return True

    def warm_up(self, device, run):
        self.warm_ups += 1
        run()

    def capture(self, device, run):
        self.captures += 1
        out = run()
        return (run, out), out

    def replay(self, device, graph):
        self.replays += 1
        run, out = graph
        before = cs.launch_counts()
        spans_were_on = profiling.enable_spans(False)
        try:
            for o, n in zip(out, run()):
                o.copy_(n)
        finally:
            profiling.enable_spans(spans_were_on)
        cs.reset_launch_counts()
        cs.add_launch_counts(before)


@pytest.fixture
def graphs(monkeypatch):
    """A fresh refine-graph cache on the fake backend."""
    cache = pc.RefineGraphs(FakeGraphs())
    monkeypatch.setattr(pc, "_REFINE_GRAPHS", cache)
    return cache


@pytest.fixture
def counted_launches(monkeypatch):
    """The patch splat counts a launch on the CPU too, as on the card."""
    forward = cs._patches_forward

    def counting(*args, **kw):
        out = forward(*args, **kw)
        cs._launches[PATCH_LAUNCH] += 1
        return out

    monkeypatch.setattr(cs, "_patches_forward", counting)
    return lambda: cs.launch_counts()[PATCH_LAUNCH]


@pytest.fixture
def spans_on():
    was = profiling.enable_spans(True)
    profiling.take()
    yield
    profiling.enable_spans(was)
    profiling.take()


def warm_window(ev, x0, trust, maxiter=MAXITER, obj=None):
    return solver(obj, maxiter, with_x0=True, trust_radius="traced")(
        *ev, x0, trust)


# ---------------------------------------------------------------------------
# One body: the eager refine equals the loop, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("adaptive", [False, True], ids=["plain", "lifespan"])
@pytest.mark.parametrize("case", ["warm", "cold", "clamped", "unclamped"])
def test_refine_equals_the_loop_bitwise(case, adaptive):
    obj = variance_objective(adaptive_lifespan=adaptive, minimum_events=40)
    ev = batches()
    x0 = warm_start()
    if case == "warm":              # the stream's call: per-ROI inf trust
        trust = torch.full((R,), torch.inf)
        got = solver(obj, with_x0=True, trust_radius="traced")(*ev, x0,
                                                               trust)
        want = loop_refine(obj, ev, x0, trust[:, None])
    elif case == "clamped":         # a finite trust ball, static and traced
        trust = torch.linspace(0.5, 3.0, R)
        got = solver(obj, with_x0=True, trust_radius="traced")(*ev, x0,
                                                               trust)
        want = loop_refine(obj, ev, x0, trust[:, None])
        static = solver(obj, with_x0=True, trust_radius=2.0)(*ev, x0)
        want_static = loop_refine(obj, ev, x0, torch.tensor(2.0))
        for a, b in zip(static, want_static):
            assert torch.equal(a, b)
    elif case == "unclamped":
        got = solver(obj, with_x0=True)(*ev, x0)
        want = loop_refine(obj, ev, x0)
    else:                           # the grid search's seed, then the loop
        got = solver(obj)(*ev)
        loss = pc._roi_patch_loss(linvel_warp(), obj, SENSOR, ROI, 1.0)
        ex, ey, et, ep, emask, origin = ev
        on = emask != 0
        dt = torch.where(on.any(-1),
                         torch.where(on, et, -torch.inf).amax(-1)
                         - torch.where(on, et, torch.inf).amin(-1), 0.0)
        margin = min(64 - ROI[0], 128 - ROI[1]) / 2.0 - 2.0
        seed, _ = pc.grid_search_refine_batched(
            lambda p: loss(p, ex, ey, et, ep, emask, origin), 2,
            torch.clamp(margin / torch.clamp(dt, min=1e-3), max=150.0),
            num_samples_per_param=5, iters=6)
        want = loop_refine(obj, ev, seed)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# When a graph is captured and replayed
# ---------------------------------------------------------------------------

def test_cpu_never_captures_with_the_card_backend(monkeypatch):
    cache = pc.RefineGraphs()
    monkeypatch.setattr(pc, "_REFINE_GRAPHS", cache)
    ev, x0, trust = batches(), warm_start(), torch.full((R,), torch.inf)
    first = warm_window(ev, x0, trust)
    for _ in range(3):
        for a, b in zip(warm_window(ev, x0, trust), first):
            assert torch.equal(a, b)
    assert not cache.seen and not cache.entries


def test_first_sighting_eager_second_captures_then_replays(
        graphs, counted_launches, spans_on):
    fake = graphs.backend
    ev, trust = batches(), torch.full((R,), torch.inf)
    x0s = [warm_start(s) for s in (1, 2, 3, 4)]
    evals = MAXITER + 3       # f(x0), the steps, the last iterate, the answer
    want = [loop_refine(variance_objective(), ev, x0, trust[:, None])
            for x0 in x0s]
    profiling.take()
    launches, taken = [], []
    for x0, w in zip(x0s, want):
        before = counted_launches()
        got = warm_window(ev, x0, trust)
        launches.append(counted_launches() - before)
        taken.append(profiling.take())
        for a, b in zip(got, w):        # replays equal the loop too
            assert torch.equal(a, b)
    assert (fake.warm_ups, fake.captures, fake.replays) == (1, 1, 3)
    assert len(graphs.entries) == 1 and not graphs.seen
    (entry,) = graphs.entries.values()
    assert entry.launches == {PATCH_LAUNCH: evals}
    # eager; warm-up + the capture's replay; replays count what they replay
    assert launches == [evals, 2 * evals, evals, evals]
    counts = [t.counts for t in taken]
    assert [c.get(pc.GRAPH_CAPTURES, 0) for c in counts] == [0, 1, 0, 0]
    assert [c.get(pc.GRAPH_REPLAYS, 0) for c in counts] == [0, 1, 1, 1]
    grads = [sum(s.name == "cmax.grad" for s in t.spans) for t in taken]
    descents = [sum(s.name == "cmax.descent" for s in t.spans)
                for t in taken]
    assert grads == [MAXITER, 2 * MAXITER, 0, 0]
    assert descents == [1, 1, 1, 1]


@pytest.fixture
def fused_launches(monkeypatch):
    """The fused patch-loss route engages on the CPU (the wrapper runs its
    plain version there) and counts a launch, as on the card."""
    monkeypatch.setattr(pc, "FUSED_DEVICE_TYPE", "cpu")
    wrapper = cs.patch_variance_vg

    def counting(*args, **kw):
        out = wrapper(*args, **kw)
        cs._launches[FUSED_LAUNCH] += 1
        return out

    monkeypatch.setattr(cs, "patch_variance_vg", counting)
    return lambda: cs.launch_counts()[FUSED_LAUNCH]


@pytest.mark.parametrize("adaptive", [False, True], ids=["plain", "lifespan"])
def test_the_fused_route_is_captured_and_replayed_as_the_body(
        graphs, fused_launches, adaptive):
    """With the fused route, eager, captured and replayed refines equal
    the written-out loop (which takes the route too) bit for bit, and a
    replay adds the capture's launches: one fused launch an evaluation,
    none of the patch splat."""
    obj = variance_objective(adaptive_lifespan=adaptive, minimum_events=40)
    ev, trust = batches(), torch.full((R,), torch.inf)
    evals = MAXITER + 3
    launches = []
    patch_launches = cs.launch_counts()[PATCH_LAUNCH]
    for x0 in [warm_start(s) for s in (1, 2, 3, 4)]:
        want = loop_refine(obj, ev, x0, trust[:, None])
        before = fused_launches()
        got = warm_window(ev, x0, trust, obj=obj)
        launches.append(fused_launches() - before)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    (entry,) = graphs.entries.values()
    assert entry.launches == {FUSED_LAUNCH: evals}
    assert launches == [evals, 2 * evals, evals, evals]
    assert cs.launch_counts()[PATCH_LAUNCH] == patch_launches


def test_a_replay_returns_copies(graphs):
    ev, x0, trust = batches(), warm_start(), torch.full((R,), torch.inf)
    for _ in range(2):
        warm_window(ev, x0, trust)
    a = warm_window(ev, x0, trust)
    b = warm_window(ev, warm_start(2), trust)
    (entry,) = graphs.entries.values()
    assert all(o is not p for o, p in zip(a, entry.outputs))
    assert not torch.equal(a[0], b[0])


@pytest.mark.parametrize("change", ["shape", "maxiter", "clamp", "objective",
                                    "warm_vs_cold"])
def test_a_changed_key_gives_a_new_entry(graphs, change):
    ev, x0, trust = batches(), warm_start(), torch.full((R,), torch.inf)
    for _ in range(2):
        warm_window(ev, x0, trust)
    assert len(graphs.entries) == 1
    for _ in range(2):
        if change == "shape":
            ev2 = batches(capacity=2 * ev[0].shape[1])
            warm_window(ev2, x0, trust)
        elif change == "maxiter":
            warm_window(ev, x0, trust, maxiter=MAXITER + 1)
        elif change == "clamp":
            solver(with_x0=True)(*ev, x0)
        elif change == "objective":
            warm_window(ev, x0, trust, obj=sos_objective())
        else:
            solver()(*ev)
    assert len(graphs.entries) == 2
    assert graphs.backend.captures == 2


def test_bfgs_and_full_frame_objectives_never_capture(graphs):
    ev, x0, trust = batches(), warm_start(), torch.full((R,), torch.inf)
    custom = variance_objective()
    custom.name = "custom"            # not a patch objective: full frame
    for _ in range(3):
        pc.make_roi_solve_one(linvel_warp(), variance_objective(), SENSOR,
                              ROI, 1.0, MAXITER, "bfgs", GD_LR,
                              with_x0=True, trust_radius="traced")(
            *ev, x0, trust)
        warm_window(ev, x0, trust, obj=custom)
    assert not graphs.seen and not graphs.entries
    assert graphs.backend.captures == 0


def test_global_fit_runs_eagerly(graphs):
    xs, ys, ts, ps = scene()
    for _ in range(2):
        pc.fit_global_motion(xs, ys, ts, ps, SENSOR, maxiter=MAXITER,
                             device="cpu")
    assert not graphs.seen and not graphs.entries


def test_the_lru_bound_evicts_the_oldest(graphs, monkeypatch):
    monkeypatch.setattr(pc, "REFINE_GRAPHS_KEPT", 2)
    ev, x0, trust = batches(), warm_start(), torch.full((R,), torch.inf)
    for maxiter in (2, 3, 4):
        for _ in range(2):
            warm_window(ev, x0, trust, maxiter=maxiter)
    assert graphs.backend.captures == 3
    assert len(graphs.entries) == 2
    kept = sorted(k[-2] for k in graphs.entries)
    assert kept == [3, 4]
    # the evicted key is met as new: eager, then captured again
    warm_window(ev, x0, trust, maxiter=2)
    assert graphs.backend.captures == 3
    warm_window(ev, x0, trust, maxiter=2)
    assert graphs.backend.captures == 4
    assert sorted(k[-2] for k in graphs.entries) == [2, 4]


def test_stream_of_windows_replays_after_the_first_two(graphs):
    """``grid_cmax_batched`` as the stream calls it: the cold first window,
    then warm windows from the last field; answers equal to eager ones."""
    eager = pc.RefineGraphs()           # does not engage on the CPU
    outs = {}
    for name, cache in (("graph", graphs), ("eager", eager)):
        pc._REFINE_GRAPHS = cache
        prev, got = None, []
        for w in range(5):
            xs, ys, ts, ps = scene(seed=10, flow=(10.0, 5.0))
            params, _, f, valid = pc.grid_cmax_batched(
                xs, ys, ts + w, ps, roi_size=ROI, img_size=SENSOR,
                maxiter=MAXITER, x0=prev, device="cpu")
            prev = torch.where(valid[:, None], params, 0.0)
            got.append((params, f))
        outs[name] = got
    pc._REFINE_GRAPHS = graphs
    for (pa, fa), (pb, fb) in zip(outs["graph"], outs["eager"]):
        assert torch.equal(pa, pb) and torch.equal(fa, fb)
    # cold window eager (its own key), warm: eager, capture, replay, replay
    assert graphs.backend.captures == 1
    assert graphs.backend.replays == 3


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

class _NeverEngages:
    """A refine-graph backend that never engages: the eager refine on the
    card."""

    @staticmethod
    def engages(device):
        return False


@pytest.mark.cuda
def test_card_replays_of_the_fused_route_agree_with_eager(monkeypatch):
    """On the card, over a stream of windows (the small scene's, one shape):
    each warm refine through the fused route, eager and replayed from its
    graph, ends with losses within 1% of the window's scale of each other
    (the route's float atomics order its sums differently from run to
    run); every refine launches the fused kernel once an evaluation, a
    replay as many as the eager refine."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    graph_cache, eager_cache = pc.RefineGraphs(), pc.RefineGraphs(
        _NeverEngages())
    evals = MAXITER + 3
    replays = 0
    for s in range(8):
        ev = [a.cuda() for a in batches(seed=20 + s, capacity=1024)]
        x0, trust = warm_start(s).cuda(), torch.full((R,), torch.inf,
                                                     device="cuda")
        out, launches = {}, {}
        for name, cache in (("eager", eager_cache), ("graph", graph_cache)):
            monkeypatch.setattr(pc, "_REFINE_GRAPHS", cache)
            before = cs.launch_counts()
            out[name] = [a.cpu() for a in warm_window(ev, x0, trust)]
            launches[name] = {k: v - before[k] for k, v in
                              cs.launch_counts().items() if v != before[k]}
        assert launches["eager"] == {FUSED_LAUNCH: evals}, s
        if s >= 2:                      # a replay: what the graph holds
            assert launches["graph"] == {FUSED_LAUNCH: evals}, s
            replays += 1
        (pe, fe), (pg, fg) = out["eager"], out["graph"]
        scale = torch.maximum(fe.abs(), fe.abs().median())
        assert float(((fg - fe).abs() / scale).max()) <= 1e-2, s
    assert replays == 6 and len(graph_cache.entries) == 1
